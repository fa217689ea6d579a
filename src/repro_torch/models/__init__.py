"""repro_torch.models — the model zoo's serving path: configs, shared
layers, GQA and MLA attention, the MoE FFN, the RG-LRU and RWKV6 blocks,
the stacked transformer and its prefill / decode step. Port of
`repro.models` (the dense family, DeepSeek's MoE/MLA pair, rwkv6 and the
RG-LRU hybrid)."""
