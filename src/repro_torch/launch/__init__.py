"""Entry points of the port (counterpart of `repro/launch/`): `serve`,
batched prefill and greedy decode of a text model; `train`, MIFA federated
training of a text model, with its step builders in `steps`. The mesh
launchers (`dryrun`, `mesh`, `specs`) wait for ROADMAP Queue 1 item 19."""
