"""Parallelism (counterpart of `repro.parallel`): pod-local hierarchical
training with int8 delta exchange (`hierarchical`, `compression`), the
sharding rules as metadata (`sharding`) and logical activation
constraints (`constrain`). Import the submodules directly: the model
code imports `constrain`, and `hierarchical` imports the model."""
