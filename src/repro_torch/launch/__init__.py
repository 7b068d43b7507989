"""Entry points of the port (counterpart of `repro/launch/`): `serve`, batched
prefill and greedy decode of a text model. Training (`train.py`,
`steps.py`) and the mesh launchers wait (ROADMAP Queue 1 items 18–19)."""
