"""repro_torch.launch — launchers. `serve.run_model` drives the model
zoo's prefill + decode path; `serve.run_runtime_layer` the serving
engine's harvesting runtime layer."""
