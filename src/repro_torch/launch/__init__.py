"""Entry points of the port (counterpart of `repro/launch/`): `serve`,
batched prefill and greedy decode of a text model; `train`, MIFA federated
training of a text model, with its step builders in `steps`; `mesh`, the
mesh builders; `specs`, the dry-run planner (each arch x input shape's
step, its arguments as meta tensors and their placements); `dryrun`, the
driver that traces every plan on an abstract production mesh and writes
its roofline record (`roofline.analysis`)."""
