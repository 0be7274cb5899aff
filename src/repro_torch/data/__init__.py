from repro_torch.data.synthetic import SyntheticLM, batch_for, input_specs

__all__ = ["SyntheticLM", "batch_for", "input_specs"]
