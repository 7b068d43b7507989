"""Entry points of the port (counterpart of `repro/launch/`): `serve`,
batched prefill and greedy decode of a text model; `train`, MIFA federated
training of a text model, with its step builders in `steps`; `mesh`, the
mesh builders (ROADMAP Queue 1 item 19a). The dry-run launchers (`dryrun`,
`specs`) wait for item 19c."""
