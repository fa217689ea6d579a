"""repro_torch.models — the model zoo's dense serving path: configs,
shared layers, GQA attention, the stacked transformer and its
prefill / decode step. Port of `repro.models` (dense family)."""
