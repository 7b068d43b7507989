"""Split matrix products in the MIFA train step (`sharding.tensor_parallel`,
`launch.steps.make_train_step(mesh=)`): the dense GQA stack's vmap and
sequential steps on each rank's blocks, in worlds of CPU ranks, against
the unsplit step and the JAX package.

No test here opens a process group: a module-scoped fixture runs
`python tests/torch_world.py --world 2|4 --cases train` (both worlds at
once, each in a subprocess of its own under its own timeout) and, while
they run, the JAX package's unmeshed `make_train_step` on the same params
and batches. Every case takes the JAX package's params of a smoke config
(f32; qwen's qkv biases drawn from a seeded normal, the reference inits
them to zero), N = 4 clients of `TokenBatcher` streams, K = 2 local steps
of 2 x 24 tokens, G drawn from a seeded normal, and 2 rounds:

  (a) granite-3-8b, vmap, on 1x2: the head's vocab over `model`; again at
      vocab 511, the head whole;
  (b) granite on 1x4: KV 2 % 4 != 0, so k's and v's columns are gathered
      and each rank has 2 query heads;
  (c) gemma3-4b on 1x2: a local (window 16) and a global layer;
  (d) granite on 2x2: clients over `data`, products over `model`, the
      server step's sum all-reduced over data;
  (e) qwen1.5-110b, sequential, on 1x2 under its update constraint
      (`cfg.replace(fsdp=True)`'s param specs), through `plan_config` and
      `run_placed` (qkv bias);
  (f) llava-next-34b, sequential, on 1x2: patches come in replicated, the
      loss covers the text positions only;
  (g) case (a) with remat on and the chunked cross-entropy (`ce_chunk` 8):
      each layer's and each chunk's checkpoint issues its collectives
      again in the backward pass;
  (h) granite with one kv head of width 6 on 1x4: k's and v's columns
      (6) do not split over 4 ranks, so every rank computes them whole
      while its 2 query heads read them;
  (i) olmoe-1b-7b's experts over `model` (two of E = 4 a rank) on 1x2
      with remat on: each layer's recompute issues the MoE collectives
      again;
  (j) olmoe on 2x2.

Each rank compares its blocks of the params, G and the loss after each
round with its blocks of the port's unsplit step, and rank 0's split run
gathered whole is held to the JAX package's step, both at the f32 training
bound (rtol 2e-4, atol 2e-5 of each leaf's largest magnitude); every leaf
the model axis leaves whole, and the loss, bit-equal across ranks. In the
MoE cases each rank's training forward of one client's minibatch routes
as the unsplit forward does: its (E, C) tables and drops bit-equal, the
same on every rank, its expert blocks E/M experts.
In-process, with no process group: the vocab-split cross-entropy on an
axis of one rank is the unsplit losses bit for bit; the collectives pass
`vmap(grad)` and remat; a mesh of model extent 1 gives today's step; and
what the split leaves for later raises, naming its ROADMAP entry.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad, vmap

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import build_model as jax_build
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import plan_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.layers import (chunked_lm_loss,
                                       softmax_cross_entropy,
                                       vocab_split_nll)
from repro_torch.models.remat import checkpoint
from repro_torch.sharding import tensor_parallel
from repro_torch.sharding.params import (StepPlacement, carry_state_specs,
                                         take_tree)
from repro_torch.sharding.tensor_parallel import (from_model, gather_model,
                                                  to_model)
from repro_torch.tree import tree_leaves, tree_map
from torch_world import (TK, TN, TR, TRAIN_CASES, flat_tree,
                         serve_params_path, smoke, train_cfg, train_inputs)

torch.set_num_threads(1)

HELPER = Path(__file__).resolve().parent / "torch_world.py"
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5
# case -> (each GQA segment's kv layout, lm_head's vocab split)
LAYOUTS = {"a_granite_1x2": (["heads"], True),
           "a_granite_vocab511_1x2": (["heads"], False),
           "b_granite_1x4": (["whole"], True),
           "c_gemma_1x2": (["heads", "heads"], True),
           "d_granite_2x2": (["heads"], True),
           "e_qwen_sequential_1x2": (["heads"], True),
           "f_llava_sequential_1x2": (["heads"], True),
           "g_granite_remat_1x2": (["heads"], True),
           "h_granite_mqa_1x4": (["whole"], True),
           "i_olmoe_remat_1x2": (["heads"], True),
           "j_olmoe_2x2": (["heads"], True)}


def _jax_params(case: str):
    arch, change, _, _ = TRAIN_CASES[case]
    jc = jax_smoke(arch).replace(compute_dtype="float32",
                                 param_dtype="float32", fl_clients=TN,
                                 fl_local_steps=TK, **change)
    jp = jax.tree.map(np.asarray, jax_build(jc).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def bias(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jc, jax.tree_util.tree_map_with_path(bias, jp)


def _jax_rounds(case: str) -> list:
    """The JAX package's unmeshed train step, TR rounds from the case's
    params and inputs: [(params, G, loss) as numpy] a round."""
    jc, jp = _jax_params(case)
    G, rounds = train_inputs(train_cfg(case), jp)
    step = jax.jit(jax_train_step(jax_build(jc), jc, TN, TK))
    p, out = jax.tree.map(jnp.asarray, jp), []
    G = jax.tree.map(jnp.asarray, G)
    for batch, act, eta in rounds:
        p, G, m = step(p, G, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(act), jnp.float32(eta))
        out.append(jax.tree.map(np.asarray, (p, G, m["loss"])))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_train")
    procs = {}
    for w in (2, 4):
        d = out / f"w{w}"
        d.mkdir()
        for case, (_, _, shape, _) in TRAIN_CASES.items():
            if shape[0] * shape[1] == w:
                np.savez(serve_params_path(str(d), case),
                         **flat_tree(_jax_params(case)[1]))
        procs[w] = subprocess.Popen(
            [sys.executable, str(HELPER), "--world", str(w), "--cases",
             "train", "--out", str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    # the reference's rounds while the worlds run
    ref = {case: _jax_rounds(case) for case in TRAIN_CASES}
    info, arrays = {}, {}
    for w, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
            pytest.fail(f"the world of {w} ranks ran past {TIMEOUT} s")
        assert proc.returncode == 0, log[-4000:]
        info.update(json.loads((out / f"w{w}" / "results.json").read_text()))
        with np.load(out / f"w{w}" / "results.npz") as z:
            arrays.update({k: z[k] for k in z.files})
    return info, arrays, ref


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_each_rank_holds_the_blocks_of_the_unsplit_step(worlds, case):
    info, _, _ = worlds
    ranks = info[case]
    _, _, shape, _ = TRAIN_CASES[case]
    assert len(ranks) == shape[0] * shape[1]
    kv, head = LAYOUTS[case]
    for r in ranks:
        assert r["shapes"] and len(r["err"]) == TR, r
        assert max(r["err"]) <= 1.0, r
        assert all(r["replicated"]), r
        assert [v[0] for _, v in sorted(r["layouts"].items())] == kv, r
        # wq, and w1 and w3 or the experts, split everywhere; k's and v's
        # columns but in (h)
        assert all(v[1] and (v[3] or v[4])
                   and v[2] == (not case.startswith("h_"))
                   for v in r["layouts"].values()), r
        moe = case.startswith(("i_", "j_"))
        assert all(v[4] == moe for v in r["layouts"].values()), r
        if moe:
            route = r["routing"]
            assert route["tables"] and route["same"], r
            assert route["calls"] == train_cfg(case).n_layers, r
            assert set(map(tuple, r["experts"].values())) == {(2, True)}, r
        assert r["head"] == head and r["embed"], r
        assert r["sequential"] == case.startswith(("e_", "f_")), r
        # products over model: sums and gathers in the forward and backward
        # passes, and every update moved into G's blocks
        assert all(r["moved"][k] > 0 for k in ("all_reduce", "all_gather",
                                               "relayout")), r
        assert "model" in r["relayout_axes"], r


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_relayout_between_model_dims_is_an_all_to_all(worlds, case):
    """`TrainSplit.move` from a dim split over model to another and back:
    the blocks of the tensor taken whole and cut, each rank putting in
    (M - 1) / M of its block, not all of it."""
    info, _, _ = worlds
    assert all(r["exchange"] for r in info[case]), info[case]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_split_step_matches_the_reference(worlds, case):
    """The split run, gathered whole, against the JAX package's unmeshed
    `make_train_step` on the same params, G, batches and masks."""
    _, arrays, ref = worlds
    for r, (params, G, loss) in enumerate(ref[case]):
        want = flat_tree({"params": params, "G": G})
        got = {k[len(f"{case}/r{r}/"):]: v for k, v in arrays.items()
               if k.startswith(f"{case}/r{r}/") and not k.endswith("loss")}
        assert sorted(got) == sorted(want)
        for k, a in want.items():
            np.testing.assert_allclose(
                got[k], a, rtol=RTOL,
                atol=ATOL * max(float(np.abs(a).max()), 1e-30), err_msg=k)
        np.testing.assert_allclose(arrays[f"{case}/r{r}/loss"], loss,
                                   rtol=RTOL, atol=ATOL)


class _OneRank:
    """An axis of one rank: the collectives of `ModelAxis` without a
    group."""

    rank, size = 0, 1

    def sum(self, x):
        return x.to(torch.float32, copy=True).to(x.dtype)

    def max(self, x):
        return x.clone()

    def gather(self, x, dim):
        return torch.cat([x.contiguous()], dim=dim)


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_split_cross_entropy_on_one_rank_is_bit_equal(masked):
    """`vocab_split_nll` on an axis of one rank gives the unsplit losses
    and gradients bit for bit: `softmax_cross_entropy` and
    `chunked_lm_loss` (through its chunk checkpoint)."""
    gen = torch.Generator().manual_seed(int(masked))
    ax = _OneRank()
    logits = torch.randn((2, 6, 13), generator=gen)
    labels = torch.randint(0, 13, (2, 6), generator=gen)
    mask = (torch.rand((2, 6), generator=gen) > 0.3).float() if masked \
        else None

    def ce(lg, axis=None):
        return softmax_cross_entropy(lg, labels, mask, axis=axis)
    assert torch.equal(ce(logits), ce(logits, ax))
    assert torch.equal(grad(ce)(logits), grad(lambda x: ce(x, ax))(logits))
    h = torch.randn((2, 8, 5), generator=gen)
    w = torch.randn((5, 13), generator=gen)
    lab = torch.randint(0, 13, (2, 8), generator=gen)
    mm = None if mask is None else torch.ones((2, 8))

    def chunked(hh, ww, axis=None):
        return chunked_lm_loss(hh, ww, lab, mm, chunk=4, axis=axis)
    assert torch.equal(chunked(h, w), chunked(h, w, ax))
    for a, b in zip(grad(chunked, argnums=(0, 1))(h, w),
                    grad(lambda x, y: chunked(x, y, ax), argnums=(0, 1))(
                        h, w)):
        assert torch.equal(a, b)
    assert vocab_split_nll(logits, labels, ax).shape == labels.shape


def test_collectives_pass_vmap_grad_and_remat():
    """`to_model`, `from_model` and `gather_model` (and the vocab-split
    nll) under `vmap(grad)`, inside and outside `remat.checkpoint`, on an
    axis of one rank: the gradients of the plain ops, to f32 rounding (the
    checkpoint sums w's two gradients in another order)."""
    ax = _OneRank()
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((4, 4), generator=gen)
    xs = torch.randn((3, 2, 5, 4), generator=gen)
    zero = torch.zeros((2, 5), dtype=torch.long)

    def split(w, x):
        y = gather_model(from_model(to_model(x, ax) @ w, ax), -1, ax)
        z = checkpoint(lambda a, b: from_model(to_model(a, ax) @ b, ax),
                       y, w)
        return (z ** 2).sum() + vocab_split_nll(z, zero, ax).sum()

    def plain(w, x):
        z = (x @ w) @ w
        lse = torch.logsumexp(z, -1)
        return (z ** 2).sum() + (lse - z[..., 0]).sum()
    got = vmap(lambda x: grad(split)(w, x))(xs)
    want = vmap(lambda x: grad(plain)(w, x))(xs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class _FakeMesh:
    """A DeviceMesh's surface without a process group: its shape, names,
    this rank's coordinate and a group of None."""

    def __init__(self, data: int, model: int, device_type: str = "cuda"):
        self.mesh_dim_names = ("data", "model")
        self.shape = (data, model)
        self.device_type = device_type

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis):
        return None


def test_model_extent_one_is_today_s_step():
    """A mesh whose model axis has extent 1 (a 4x1 mesh, an abstract
    mesh) gives no split: the step is the one built without a mesh, bit
    for bit."""
    cfg = smoke("granite_3_8b", fl_clients=TN, fl_local_steps=TK)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TN, TK, 2, 16)).astype(np.int32))}
    active = torch.tensor([True, False, True, True])

    def run(step):
        G = tree_map(lambda p: torch.full((TN,) + tuple(p.shape), 0.5),
                     params)
        return step(tree_map(torch.clone, params), G, batch, active, 0.05)
    want = run(make_train_step(model, cfg, TN, TK))
    for mesh in (_FakeMesh(4, 1, "cpu"),
                 make_abstract_mesh((1, 2), ("data", "model"))):
        step = make_train_step(model, cfg, TN, TK, mesh=mesh)
        assert getattr(step, "split", None) is None
        got = run(step)
        for a, b in zip(tree_leaves(list(got[:2])),
                        tree_leaves(list(want[:2]))):
            assert torch.equal(a, b)
        assert torch.equal(got[2]["loss"], want[2]["loss"])


def _meta_params(cfg):
    with FakeTensorMode():
        tree = build_model(cfg).init(0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_paths_left_for_12h_and_12g_raise_on_cuda():
    """On fake CUDA tensors and a fake mesh (no card, no process group):
    `StepPlacement` at model extent > 1, which entry 12h took, holds the
    round's split (its G layout the carry's), and a bare take of the scan
    carry's client state, outside a split, raises naming the entries that
    remain (12d-12f; 12i, the fleets, computes on blocks since it was
    taken); the sequential train step at data extent > 1
    raises naming 12g, both built with the mesh and planned (the plan
    keeps the gathering step, whose update constraint raises on CUDA
    blocks)."""
    cfg = smoke("granite_3_8b")
    mesh = _FakeMesh(1, 2)
    params = _meta_params(cfg)
    with FakeTensorMode():
        cuda = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cuda"), params)
        placement = StepPlacement(cuda, cfg, mesh, 4)
        assert placement.split is not None
        state = {"G": tree_map(lambda t: t.new_empty((4,) + tuple(t.shape)),
                               cuda)}
        specs = carry_state_specs(state, cuda, cfg, mesh, 4)
        assert specs["G"] == placement.split.state_specs
        with pytest.raises(NotImplementedError, match="entries 12d-12f"):
            take_tree(state, specs, mesh, "the client state")
        qwen = smoke("qwen1_5_110b", fl_clients=2)
        assert qwen.sequential_clients
        with pytest.raises(NotImplementedError, match="entry 12g"):
            make_train_step(build_model(qwen), qwen, 2, 1,
                            mesh=_FakeMesh(2, 2))
        plan = plan_config(qwen, "train_4k", _FakeMesh(2, 2),
                           inner_update_constraint=True)
        assert getattr(plan.fn, "split", None) is None
        qp = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="cuda"), _meta_params(qwen))
        G = tree_map(lambda t: t.new_empty((2,) + tuple(t.shape)), qp)
        batch = {"tokens": torch.zeros((2, 1, 2, 8), dtype=torch.int32,
                                       device="cuda")}
        with pytest.raises(NotImplementedError, match="entry 12g"):
            plan.fn(qp, G, batch, torch.ones(2, dtype=torch.bool,
                                             device="cuda"), 0.1)


@pytest.mark.parametrize("arch,change,mesh,n,entry", [
    ("olmoe_1b_7b", {"fsdp": True}, (2, 2), 4, "12g"),
    ("deepseek_v2_lite_16b", {}, (1, 2), 4, "12d"),
    ("zamba2_7b", {}, (1, 2), 4, "12e"),
    ("hubert_xlarge", {}, (1, 2), 4, "12f"),
    ("granite_3_8b", {"pad_q_heads": 16, "pad_kv_heads": 16}, (1, 2), 4,
     "12f"),
    ("granite_3_8b", {"fsdp": True}, (2, 2), 4, "12g"),
    ("granite_3_8b", {}, (2, 2), 3, "12g"),
    ("granite_3_8b", {}, (2, 2), 4, "12g"),
    ("qwen1_5_110b", {}, (2, 2), 4, "12g"),
])
def test_what_the_train_split_leaves_for_later_raises(arch, change, mesh, n,
                                                      entry):
    """`make_train_step(mesh=)` of a config or mesh the split does not
    take yet raises NotImplementedError naming its ROADMAP entry (the
    same `unsupported` that refuses the serving steps, with the training
    case: N not divisible by the data extent, the sequential step over
    data ranks, the client axis over data ranks on the card), and the
    planner keeps such train plans on the gathering route."""
    cfg = smoke(arch, fl_clients=n, **change)
    fake = _FakeMesh(*mesh)
    with pytest.raises(NotImplementedError, match=f"entry {entry}"):
        make_train_step(build_model(cfg), cfg, n, 1, mesh=fake)
    assert entry in tensor_parallel.unsupported(cfg, fake, n, train=True)
    assert getattr(plan_config(cfg, "train_4k", fake).fn, "split",
                   None) is None
    # the same data-parallel vmap split is taken on CPU ranks
    if (arch, change, n) == ("granite_3_8b", {}, 4):
        assert tensor_parallel.unsupported(
            cfg, _FakeMesh(2, 2, "cpu"), n, train=True) is None
