#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It
  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions and the TF32 switches;
  2. builds the hand-written CUDA kernels from `src/repro_torch/kernels/csrc`
     with nvcc (one process per source, in parallel), timed;
  3. holds every kernel against its plain PyTorch version on the card, at
     the main path's leaf shapes and at edge cases (ragged width, nothing
     active, only pad slots, bf16 storage), and times kernel and plain
     version per round of the main path beside the least time the card
     could take for the same bytes and operations;
  4. runs the main path — the paper's experiment (`paper_mlp` at full
     width: N=100 clients, d=256, 2x128 hidden, K=5 local steps, batch 100,
     label-correlated Bernoulli availability with p_min=0.1, inv_t(1.0),
     weight decay 1e-3) for 100 rounds of `run_fl(engine="loop")` with
     `MIFA(memory="array")` and with `BankedMIFA(DenseBank())`, from the
     same initial params and participation seed, and checks the losses,
     the anchor property (both algorithms give the same trajectory) and
     that each path launched its kernel once per leaf per round;
  5. runs 5 rounds of both algorithms on the CPU (plain versions) and on
     the card (kernels) and holds them together.
It exits non-zero on any failure. Its last two lines are one JSON object per
kernel list, then {"ok": true, "device": {...}}. It imports no JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 outside the tensor
# cores; both kernels do f32 adds and subtracts only.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50e6

N_CLIENTS = 100
# flattened leaf widths of paper_mlp in leaf order: layers[0].b,
# layers[0].w (256x128), layers[1].b, layers[1].w (128x128), out.b,
# out.w (128x10)
PATH_WIDTHS = [128, 32768, 128, 16384, 10, 1280]
ROUNDS = 100
CPU_ROUNDS = 5
# MIFA(array) and BankedMIFA(dense) agree in exact arithmetic; in fp32 the
# bank keeps G_sum incrementally while the dense step re-sums all N rows, so
# the trajectories drift apart by reduction-order rounding over 100 rounds.
ANCHOR_RTOL, ANCHOR_ATOL = 1e-3, 1e-5
# card vs CPU: fp32 on both, with matmuls and reductions blocked
# differently; the rounding differences pass through 25 SGD steps at
# learning rates up to 1.0 (inv_t), which moves single params by a few 1e-5
# on |params| < 0.5, while the losses stay within 1e-6
DEVICE_RTOL, DEVICE_ATOL = 1e-4, 1e-4
# kernel vs plain version. Selected and copied values (G, bank rows) must be
# bit-equal. Sums are taken in another order, which moves an f32 sum of n
# terms by up to about n·eps·Σ|terms|, so the relative tolerance applies to
# the sum of the magnitudes of the terms (plus |w| for w): f32 results
# rtol 1e-5, atol 1e-6; bf16 results may land one bf16 rounding apart,
# rtol 1e-2.
TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-2, 1e-2)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# --------------------------------------------------------------------------- #
# the paper's problem, rebuilt from the port's modules
# --------------------------------------------------------------------------- #

def paper_problem(model_name: str = "paper_mlp", *, n_clients: int = N_CLIENTS,
                  p_min: float = 0.1, n_per_class: int = 500,
                  batch_size: int = 100, k_steps: int = 5, seed: int = 0,
                  device: str = "cuda"):
    """The paper §7 setup on synthetic non-iid data: N clients with 2 classes
    each, label-correlated Bernoulli availability, batch 100."""
    from repro_torch.configs import get_config
    from repro_torch.core import label_correlated_probs
    from repro_torch.data import (ClientBatcher, label_skew_partition,
                                  make_classification)
    from repro_torch.models import build_model

    cfg = get_config(model_name).replace(fl_clients=n_clients)
    model = build_model(cfg)
    X, y = make_classification(10, cfg.d_model, n_per_class, noise=1.0,
                               seed=seed)
    Xte, yte = make_classification(10, cfg.d_model, 100, noise=1.0,
                                   seed=seed + 1000)
    idx, labels = label_skew_partition(y, n_clients, seed=seed)
    probs = label_correlated_probs(labels, p_min=p_min)
    batcher = ClientBatcher(X, y, idx, batch_size=batch_size, k_steps=k_steps,
                            seed=seed)
    # the features come back as float64 under numpy 2 promotion; the
    # reference's eval feeds them through jnp.asarray, i.e. as float32
    test = {"x": torch.from_numpy(Xte).to(device, torch.float32),
            "y": torch.from_numpy(yte).to(device)}

    def eval_fn(params):
        with torch.no_grad():
            loss, _ = model.loss_fn(params, test)
            return float(loss), float(model.accuracy(params, test))

    return model, batcher, probs, eval_fn


class TimedParticipation:
    """Bernoulli availability that stamps the host clock as each round
    starts; every round ends in a device sync (the history reads the round's
    loss), so consecutive stamps bound one whole round."""

    def __init__(self, inner):
        self.inner = inner
        self.stamps: list[float] = []

    def sample(self, t: int) -> np.ndarray:
        self.stamps.append(time.perf_counter())
        return self.inner.sample(t)


# --------------------------------------------------------------------------- #
# kernel checks and timing
# --------------------------------------------------------------------------- #

def time_round_ms(calls, iters: int = 20) -> float:
    """Device ms for one pass over `calls`, from a CUDA graph of the calls
    replayed `iters` times between CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(set_bytes: int) -> int:
    """Input sets to cycle through so each launch finds its inputs outside
    the 50 MB L2 cache, as the round does after local training."""
    return int(min(32, max(2, math.ceil(3 * L2_BYTES / set_bytes))))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mifa_inputs(gen, n, m, g_dtype, w_dtype, active):
    dev = "cuda"
    g = torch.randn((n, m), generator=gen, device=dev).to(g_dtype)
    u = torch.randn((n, m), generator=gen, device=dev)
    w = torch.randn((m,), generator=gen, device=dev).to(w_dtype)
    return g, u, active, w


def check_mifa(gen, active_path) -> tuple[float, list]:
    from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                    mifa_aggregate_ref)
    n, eta = N_CLIENTS, 0.07
    none_active = torch.zeros(n, dtype=torch.bool, device="cuda")
    cases = [(m, torch.float32, torch.float32, active_path, "path")
             for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32, torch.float32, active_path, "ragged"),
              (1000, torch.float32, torch.float32, none_active, "none active"),
              (32768, torch.bfloat16, torch.float32, active_path, "bf16 G"),
              (1000, torch.bfloat16, torch.float32, active_path,
               "bf16 G ragged"),
              (1000, torch.bfloat16, torch.bfloat16, active_path,
               "bf16 G and w")]
    max_err, rows = 0.0, []
    for m, gdt, wdt, act, label in cases:
        g, u, act, w = mifa_inputs(gen, n, m, gdt, wdt, act)
        g_ref, w_ref = mifa_aggregate_ref(g, u, act, w, eta)
        g_k, w_k = mifa_aggregate(g.clone(), u, act, w, eta)
        torch.cuda.synchronize()
        check(torch.equal(g_k, g_ref), f"mifa_aggregate G differs ({label}, "
                                       f"M={m})")
        rtol, atol = TOL[wdt]
        err = (w_k.float() - w_ref.float()).abs()
        scale = w.float().abs() + eta * g_ref.float().abs().mean(0)
        check(bool((err <= atol + rtol * scale).all()),
              f"mifa_aggregate w off by {err.max().item():.3e} ({label}, "
              f"M={m})")
        max_err = max(max_err, err.max().item())
        rows.append(f"mifa_aggregate {label:<14} N={n} M={m:<6} G {gdt} "
                    f"w {wdt}: G bit-equal, max |dw| {err.max().item():.3e}")
    return max_err, rows


def time_path(kernel, plain, sets, leaf_bytes, leaf_ops) -> dict:
    """Time `kernel` and `plain` over the main path's leaves: per round
    (the 6 leaves back to back) and per launch at each leaf's shape. `sets`
    holds copies of the per-leaf arguments, cycled so that each launch
    finds its inputs cold."""
    n = len(sets)
    out = {"ms": time_round_ms([lambda a=a: kernel(*a)
                                for s in sets for a in s]) / n,
           "plain_ms": time_round_ms([lambda a=a: plain(*a)
                                      for s in sets for a in s]) / n}
    out["bound_ms"], out["bound_by"] = bound(sum(leaf_bytes), sum(leaf_ops))
    out["bytes"] = sum(leaf_bytes)
    out["leaves"] = []
    for j, m in enumerate(PATH_WIDTHS):
        out["leaves"].append({
            "M": m,
            "us": time_round_ms([lambda a=s[j]: kernel(*a)
                                 for s in sets]) / n * 1e3,
            "plain_us": time_round_ms([lambda a=s[j]: plain(*a)
                                       for s in sets]) / n * 1e3,
            "bound_us": bound(leaf_bytes[j], leaf_ops[j])[0] * 1e3})
    return out


def time_mifa(gen, active_path) -> dict:
    """The dense server step on the main path: one launch per leaf of
    paper_mlp at N=100, with this run's active mask."""
    from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                    mifa_aggregate_ref)
    n, eta = N_CLIENTS, 0.07
    n_act = int(active_path.sum())
    set_bytes = sum(2 * n * m * 4 for m in PATH_WIDTHS)
    sets = [[mifa_inputs(gen, n, m, torch.float32, torch.float32,
                         active_path) for m in PATH_WIDTHS]
            for _ in range(n_copies(set_bytes))]
    leaf_bytes = [n_act * m * 4 + (n - n_act) * m * 4   # U or G read
                  + n_act * m * 4                       # active rows of G
                  + 2 * m * 4 + n                       # w, w_new, mask
                  for m in PATH_WIDTHS]
    leaf_ops = [n * m + 2 * m for m in PATH_WIDTHS]
    return time_path(lambda *a: mifa_aggregate(*a, eta),
                     lambda *a: mifa_aggregate_ref(*a, eta), sets,
                     leaf_bytes, leaf_ops)


def bank_inputs(gen, r, m, c, bank_dtype, ids, valid):
    bank = torch.randn((r, m), generator=gen, device="cuda").to(bank_dtype)
    u = torch.randn((c, m), generator=gen, device="cuda")
    return bank, u, ids, valid


def cohort(active_path) -> tuple[torch.Tensor, torch.Tensor]:
    """The runner's padded cohort for a mask: active ids, then pad slots at
    the dummy row N up to the power-of-two bucket."""
    from repro_torch.core.runner import pad_cohort
    padded, valid = pad_cohort(np.flatnonzero(active_path.cpu().numpy()),
                               N_CLIENTS)
    return (torch.from_numpy(padded).cuda(), torch.from_numpy(valid).cuda())


def check_bank(gen, active_path) -> tuple[float, list]:
    from repro_torch.kernels.bank_scatter import bank_scatter, bank_scatter_ref
    r = N_CLIENTS + 1
    path = cohort(active_path)
    ids, valid = path
    all_pad = (ids, torch.zeros_like(valid))
    # C=64 with 37 valid slots, then 27 pads at the dummy row N
    picks = torch.randperm(N_CLIENTS, generator=torch.Generator().manual_seed(
        37))[:37]
    c64 = cohort(torch.zeros(N_CLIENTS, dtype=torch.bool).index_fill_(
        0, picks, True))
    cases = [(m, torch.float32, path, "path")
             for m in sorted(set(PATH_WIDTHS))]
    cases += [(1000, torch.float32, path, "ragged"),
              (1000, torch.float32, all_pad, "all pad"),
              (32768, torch.float32, c64, "C=64, 37 valid"),
              (32768, torch.bfloat16, path, "bf16 bank"),
              (1000, torch.bfloat16, c64, "bf16 ragged")]
    max_err, rows = 0.0, []
    for m, bdt, (ids, val), label in cases:
        bank, u, _, _ = bank_inputs(gen, r, m, len(ids), bdt, ids, val)
        b_ref, d_ref = bank_scatter_ref(bank, u, ids, val)
        b_k, d_k = bank_scatter(bank.clone(), u, ids, val)
        torch.cuda.synchronize()
        check(torch.equal(b_k, b_ref), f"bank_scatter rows differ ({label}, "
                                       f"M={m})")
        rtol, atol = TOL[torch.float32]           # dsum is f32 for any bank
        err = (d_k - d_ref).abs()
        terms = u.to(bdt).float() - bank[ids].float()
        scale = (terms.abs() * val.reshape(-1, 1)).sum(0)
        check(bool((err <= atol + rtol * scale).all()),
              f"bank_scatter dsum off by {err.max().item():.3e} ({label}, "
              f"M={m})")
        max_err = max(max_err, err.max().item())
        rows.append(f"bank_scatter   {label:<14} R={r} C={len(ids)} "
                    f"valid={int(val.sum())} M={m:<6} bank {bdt}: rows "
                    f"bit-equal, max |d dsum| {err.max().item():.3e}")
    return max_err, rows


def time_bank(gen, active_path) -> dict:
    """The cohort bank update on the main path: one launch per leaf of
    paper_mlp, the runner's padded cohort for this run's active mask."""
    from repro_torch.kernels.bank_scatter import bank_scatter, bank_scatter_ref
    r = N_CLIENTS + 1
    ids, valid = cohort(active_path)
    c, n_valid = len(ids), int(valid.sum())
    set_bytes = sum((r + c) * m * 4 for m in PATH_WIDTHS)
    sets = [[bank_inputs(gen, r, m, c, torch.float32, ids, valid)
             for m in PATH_WIDTHS] for _ in range(n_copies(set_bytes))]
    # rows (read old, read update, write new), dsum, ids and valid
    leaf_bytes = [3 * n_valid * m * 4 + m * 4 + c * 9 for m in PATH_WIDTHS]
    leaf_ops = [2 * n_valid * m for m in PATH_WIDTHS]
    return time_path(bank_scatter, bank_scatter_ref, sets, leaf_bytes,
                     leaf_ops)


# --------------------------------------------------------------------------- #
# the main path
# --------------------------------------------------------------------------- #

def clone_tree(params, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda p: p.detach().to(device).clone(), params)


def run_path(name, algo, problem, params0, n_rounds, device, eval_every):
    from repro_torch.core import BernoulliParticipation, run_fl
    from repro_torch.optim import inv_t
    model, batcher, probs, eval_fn = problem
    part = TimedParticipation(BernoulliParticipation(probs, seed=1))
    params, hist = run_fl(model=model, algo=algo, participation=part,
                          batcher=batcher, schedule=inv_t(1.0),
                          n_rounds=n_rounds, weight_decay=1e-3,
                          params=clone_tree(params0, device),
                          eval_fn=eval_fn, eval_every=eval_every,
                          device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return params, hist, np.diff(part.stamps)


def main_path(params0, problem) -> tuple[dict, list]:
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA
    from repro_torch.kernels.bank_scatter import bank_scatter
    from repro_torch.kernels.mifa_aggregate import mifa_aggregate
    from repro_torch.tree import tree_leaves

    n_leaves = len(tree_leaves(params0))
    check([p.numel() for p in tree_leaves(params0)] == PATH_WIDTHS,
          "paper_mlp leaf widths changed")
    counters = {"mifa_aggregate": mifa_aggregate, "bank_scatter": bank_scatter}
    paths = {"mifa_array": (MIFA(memory="array"), "mifa_aggregate"),
             "banked_dense": (BankedMIFA(DenseBank(device="cuda")),
                              "bank_scatter")}
    launches, hists, rows = {}, {}, []
    for name, (algo, kernel) in paths.items():
        for fn in counters.values():
            fn.launches = 0
        params, hist, dts = run_path(name, algo, problem, params0, ROUNDS,
                                     "cuda", ROUNDS)
        counts = {k: fn.launches for k, fn in counters.items()}
        launches[kernel] = counts[kernel]
        check(counts[kernel] == ROUNDS * n_leaves,
              f"{name}: {kernel} launched {counts[kernel]} times, expected "
              f"{ROUNDS} rounds x {n_leaves} leaves")
        others = {k: v for k, v in counts.items() if k != kernel}
        check(not any(others.values()), f"{name}: other kernels ran {others}")
        losses = np.asarray(hist.train_loss)
        check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
        check(all(math.isfinite(p.float().abs().max().item())
                  for p in tree_leaves(params)), f"{name}: non-finite params")
        (t_first, el0), (t_last, el1) = hist.eval_loss[0], hist.eval_loss[-1]
        check(el1 < el0, f"{name}: eval loss {el1:.4f} at round {t_last} is "
                         f"not below {el0:.4f} at round {t_first}")
        hists[name] = hist
        steady = dts[10:]           # rounds 10..98: past warm-up and eval
        rows.append(
            f"main path {name}: {ROUNDS} rounds, median "
            f"{np.median(steady) * 1e3:.3f} ms/round (rounds 10-{ROUNDS - 2}, "
            f"host clock), mean |A(t)| {np.mean(hist.n_active):.2f}, "
            f"eval loss {el0:.4f} -> {el1:.4f}, acc "
            f"{hist.eval_acc[-1][1]:.4f}, tau_bar {hist.tau_bar:.4f}, "
            f"{kernel} launches {counts[kernel]}")
    a = np.asarray(hists["mifa_array"].train_loss)
    b = np.asarray(hists["banked_dense"].train_loss)
    rel = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))
    rows.append(f"anchor: max rel train-loss gap MIFA(array) vs "
                f"BankedMIFA(dense) over {ROUNDS} rounds {rel:.3e} "
                f"(rtol {ANCHOR_RTOL}, atol {ANCHOR_ATOL})")
    check(np.allclose(a, b, rtol=ANCHOR_RTOL, atol=ANCHOR_ATOL),
          "anchor property: MIFA(array) and BankedMIFA(dense) diverge")
    check(hists["mifa_array"].n_active == hists["banked_dense"].n_active,
          "the two paths saw different masks")
    return launches, rows


def card_vs_cpu(params0, problem_cuda, problem_cpu) -> None:
    from repro_torch.bank import BankedMIFA, DenseBank
    from repro_torch.core import MIFA
    from repro_torch.tree import tree_leaves
    for name, make in (("mifa_array", lambda d: MIFA(memory="array")),
                       ("banked_dense",
                        lambda d: BankedMIFA(DenseBank(device=d)))):
        out = {}
        for dev, prob in (("cpu", problem_cpu), ("cuda", problem_cuda)):
            out[dev] = run_path(name, make(dev), prob, params0, CPU_ROUNDS,
                                dev, CPU_ROUNDS)
        (p_cpu, h_cpu, _), (p_gpu, h_gpu, _) = out["cpu"], out["cuda"]
        pairs = [(x, y.cpu()) for x, y in zip(tree_leaves(p_cpu),
                                               tree_leaves(p_gpu))]
        dparam = [(x - y).abs().max().item() for x, y in pairs]
        dloss = np.abs(np.subtract(h_cpu.train_loss, h_gpu.train_loss))
        print(f"card vs CPU {name}: {CPU_ROUNDS} rounds, max |dparam| per "
              f"leaf {['%.2e' % d for d in dparam]}, |dloss| per round "
              f"{['%.2e' % d for d in dloss]} (rtol {DEVICE_RTOL}, atol "
              f"{DEVICE_ATOL})")
        for x, y in pairs:
            check(torch.allclose(x, y, rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
                  f"{name}: card and CPU params differ")
        check(np.allclose(h_cpu.train_loss, h_gpu.train_loss,
                          rtol=DEVICE_RTOL, atol=DEVICE_ATOL),
              f"{name}: card and CPU losses differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import backend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    backend.set_numerics()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = backend.build_kernels()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    problem = paper_problem(device="cuda")
    params0 = problem[0].init(0, device="cuda")
    from repro_torch.core import BernoulliParticipation
    # a typical round for the kernels' timing: the median-|A| mask among
    # rounds 1-21 of the main path's participation stream
    part = BernoulliParticipation(problem[2], seed=1)
    masks = [part.sample(t) for t in range(22)][1:]
    typical = sorted(masks, key=lambda m: m.sum())[len(masks) // 2]
    active_path = torch.from_numpy(typical).cuda()

    gen = torch.Generator(device="cuda").manual_seed(0)
    mifa_err, rows = check_mifa(gen, active_path)
    bank_err, more = check_bank(gen, active_path)
    for row in rows + more:
        print(row)
    timing = {"mifa_aggregate": time_mifa(gen, active_path),
              "bank_scatter": time_bank(gen, active_path)}
    for name, t in timing.items():
        print(f"{name} per round (6 leaves of paper_mlp, |A|="
              f"{int(active_path.sum())}): kernel {t['ms'] * 1e3:.2f} us, "
              f"plain {t['plain_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
              f"{t['bytes']} bytes)")
        for leaf in t["leaves"]:
            print(f"  {name} M={leaf['M']:<6} per launch: kernel "
                  f"{leaf['us']:.2f} us, plain {leaf['plain_us']:.2f} us, "
                  f"bound {leaf['bound_us']:.2f} us")

    launches, rows = main_path(params0, problem)
    for row in rows:
        print(row)
    card_vs_cpu(params0, problem, paper_problem(device="cpu"))

    entries = []
    for name, src, tpu, err in (
            ("mifa_aggregate", "mifa_aggregate.cu",
             "src/repro/kernels/mifa_aggregate.py:24", mifa_err),
            ("bank_scatter", "bank_scatter.cu",
             "src/repro/kernels/bank_scatter.py:44", bank_err)):
        t = timing[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call computes either function (PERF.md)
            "library_ms": None,
            # ms, plain_ms and bound_ms are per round (one launch per
            # leaf); this is per launch at each leaf's width
            "per_launch_us": t["leaves"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
