"""repro_torch.launch — launchers. `serve.run_model` drives the model
zoo's prefill + decode path; `serve.run_runtime_layer` the serving
engine's harvesting runtime layer; `train` the trainer. `mesh` builds
`torch.distributed` device meshes, `runtime` holds the serve mesh that
sharded decode reads, `sharding` the spec rules."""
