"""repro_torch.launch — launchers. This slice carries the serving
engine's runtime-layer driver (`serve.run_runtime_layer`)."""
