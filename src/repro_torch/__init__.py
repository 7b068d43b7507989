"""PyTorch port of the MIFA reproduction, for NVIDIA Hopper (H100).

The JAX package `repro` is the reference; this package mirrors its layout
(`configs`, `data`, `optim`, `core`, `models`, `kernels`, `bank`) for the
slices that have been ported: the paper's round-synchronous experiment
(`core.runner.run_fl` with `MIFA(memory="array"|"delta")`,
`BankedMIFA(DenseBank())` and `BankedMIFA(PagedDeviceBank(...))` on the
tabular paper models), million-client cohort rounds through the paged
bank and `data.ProceduralBatcher`, and the later slices listed in
ROADMAP.md (fleets, the scan engine, scenarios, the runtime simulator
`sim`, the host bank, serving three zoo models).

Device rule: every entry point takes `device=` and defaults to "cuda"; with
no GPU it raises unless the caller passes `device="cpu"`. Kernel wrappers
decide by the tensor's device alone: a CUDA tensor launches the hand-written
CUDA kernel (or raises), a CPU tensor takes the plain PyTorch version.

This package imports neither `jax` nor anything of `repro`.
"""
