"""Lock protocols as instruction programs (foMPI baselines, RMA family)."""
