"""Split matrix products on the serving path (`sharding.tensor_parallel`):
the dense GQA stack's prefill and decode on each rank's blocks, in worlds
of CPU ranks, against the unsplit run and the JAX package.

No test here opens a process group: a module-scoped fixture runs
`python tests/torch_world.py --world 2|4 --cases serve` (both worlds at
once, each in a subprocess of its own under its own timeout). Every case
takes the JAX package's params of a smoke config (f32; qwen's qkv biases
drawn from a seeded normal, the reference inits them to zero), a prefill
of 2 x 24 tokens and 3 greedy decode steps, and each rank compares its
blocks of the prefill logits, the cache after the prefill, every decode
step's logits and the final cache with its blocks of the unsplit run:

  (a) granite-3-8b on 1x2: the cache over kv heads (KV 2 % 2 = 0), the
      head's vocab over `model`; again at vocab 511, the head whole;
  (b) qwen1.5-110b on 1x2 (qkv bias, vocab-split logits);
  (c) granite on 1x4: KV 2 % 4 != 0, the cache split over its slots and k,
      v split inside a head (the flash-decode path);
  (d) gemma3-4b on 1x4: its ring of 16 slots split 4 a rank, its global
      layer's 30 slots whole on every rank;
  (e) granite on 2x2: data and model together;
  (f) olmoe-1b-7b's experts over `model` on 1x2 (E = 4: two a rank) and
      on 1x4 (one a rank) at a capacity factor of 1.0, which drops
      assignments in prefill and decode;
  (g) olmoe with a shared SwiGLU (its columns split as a dense MLP's);
  (h) olmoe with 6 experts on 1x4: M does not divide E, so every rank
      computes every expert;
  (i) moonshot-v1-16b-a3b on 1x2.

Every MoE case routes every token on every rank: each routing call's
(E, C) table and drops are bit-equal to the unsplit run's and the same on
every rank, and each rank's expert blocks hold E/M experts (E where M
does not divide E).

Tolerance: rtol 2e-4 / atol 2e-5, `tests/test_torch_models.py`'s f32
bound, against the unsplit run and against the JAX package's unmeshed
`prefill` and `decode_step` (run here, teacher-forced with the world's
greedy tokens); greedy tokens equal; every leaf and output the model axis
leaves whole bit-equal over each model group. The partial decode and its
combine are checked in-process against `decode_attend`, the MoE block
form over simulated ranks against `moe_apply`, and the paths the split
does not take yet raise, naming their ROADMAP entry.
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
from repro.models import build_model as jax_build
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import plan_config
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import attention, build_model
from repro_torch.sharding import rules, tensor_parallel
from repro_torch.sharding.params import StepPlacement, block_shape, take
from repro_torch.tree import tree_leaves, tree_map
from torch_world import (SB, SERVE_CASES, SS, ST, flat_tree,
                         serve_params_path, serve_tokens, smoke)

torch.set_num_threads(1)

HELPER = Path(__file__).resolve().parent / "torch_world.py"
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5
# case -> (the GQA segments' cache layouts, lm_head's vocab split)
LAYOUTS = {"a_granite_1x2": (["heads"], True),
           "a_granite_vocab511_1x2": (["heads"], False),
           "b_qwen_1x2": (["heads"], True),
           "c_granite_1x4": (["seq"], True),
           "d_gemma_1x4": (["seq", "whole"], True),
           "e_granite_2x2": (["heads"], True),
           "f_olmoe_1x2": (["heads"], True),
           "f_olmoe_drops_1x4": (["heads"], True),
           "g_olmoe_shared_1x2": (["heads"], True),
           "h_olmoe_whole_experts_1x4": (["heads"], True),
           "i_moonshot_1x2": (["heads"], True)}
# MoE case -> (experts in a rank's block, split over `model`)
EXPERTS = {"f_olmoe_1x2": (2, True), "f_olmoe_drops_1x4": (1, True),
           "g_olmoe_shared_1x2": (2, True),
           "h_olmoe_whole_experts_1x4": (6, False),
           "i_moonshot_1x2": (2, True)}


def _jax_params(case: str):
    arch, change, _, _ = SERVE_CASES[case]
    jc = jax_smoke(arch).replace(compute_dtype="float32",
                                 param_dtype="float32", **change)
    jp = jax.tree.map(np.asarray, jax_build(jc).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def bias(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jc, jax.tree_util.tree_map_with_path(bias, jp)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_serve")
    procs = {}
    for w in (2, 4):
        d = out / f"w{w}"
        d.mkdir()
        for case, (_, _, shape, _) in SERVE_CASES.items():
            if shape[0] * shape[1] == w:
                np.savez(serve_params_path(str(d), case),
                         **flat_tree(_jax_params(case)[1]))
        procs[w] = subprocess.Popen(
            [sys.executable, str(HELPER), "--world", str(w), "--cases",
             "serve", "--out", str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
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
    return info, arrays


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_each_rank_holds_the_blocks_of_the_unsplit_run(worlds, case):
    info, _ = worlds
    ranks = info[case]
    _, _, shape, _ = SERVE_CASES[case]
    assert len(ranks) == shape[0] * shape[1]
    caches, head = LAYOUTS[case]
    for r in ranks:
        assert r["shapes"] and r["err"] <= 1.0, r
        assert r["greedy"] and r["replicated"], r
        assert [v[0] for _, v in sorted(r["layouts"].items())] == caches, r
        assert r["head"] == head and r["embed"], r
        assert r["moved"]["all_reduce"] > 0 and r["moved"]["all_gather"] > 0
        if case not in EXPERTS:
            assert r["experts"] == {} and r["routing"]["calls"] == 0, r


@pytest.mark.parametrize("case", list(EXPERTS))
def test_each_rank_routes_every_token_and_computes_its_experts(worlds,
                                                               case):
    """An MoE case: every rank's routing calls (one a layer in the
    prefill and in each decode step) give the unsplit run's (E, C) tables
    and drops bit for bit, the same on every rank; its expert blocks hold
    E/M experts (all E where M does not divide E), and a shared SwiGLU's
    columns split."""
    info, _ = worlds
    arch, change, _, _ = SERVE_CASES[case]
    n_moe = smoke(arch, **change).n_layers
    for r in info[case]:
        route = r["routing"]
        assert route["tables"] and route["same"], r
        assert route["calls"] == n_moe * (1 + ST), r
        assert set(map(tuple, r["experts"].values())) == {EXPERTS[case]}, r
        assert [v[3] for v in r["layouts"].values()] == [
            "n_shared_experts" in change], r
        if case == "f_olmoe_drops_1x4":
            assert sum(route["drops"]) > 0, r
        else:
            assert sum(route["drops"]) == 0, r


def test_a_split_plan_runs_its_blocks_through_run_placed(worlds):
    """Granite's `decode_32k` plan on 1x2: `run_placed` hands each rank's
    blocks to the split step, which returns the rank's vocab block of the
    logits and its kv heads of the cache, within the f32 bound of the
    unsplit step's blocks."""
    info, _ = worlds
    ranks = info["placed_decode_1x2"]
    assert len(ranks) == 2
    for r in ranks:
        assert r["split"] and r["shapes"] and r["err"] <= 1.0, r
        assert r["blocks"] == [SB, 256], r


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_split_run_matches_the_reference(worlds, case):
    """The split run's outputs, gathered whole, against the JAX package's
    unmeshed prefill and decode_step on the same params and tokens."""
    _, arrays = worlds
    jc, jp = _jax_params(case)
    jm = jax_build(jc)
    toks = arrays[f"{case}/tokens"]
    greedy = arrays[f"{case}/greedy"]
    C = int(arrays[f"{case}/cache_len"])
    assert toks.shape == (SB, SS) and greedy.shape == (SB, ST)
    np.testing.assert_array_equal(toks, serve_tokens(jc))
    logits, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jm.init_cache(SB, C))
    step = jax.jit(jm.decode_step)
    for i in range(ST):
        np.testing.assert_allclose(arrays[f"{case}/logits{i}"],
                                   np.asarray(logits), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.asarray(logits).argmax(-1),
                                      greedy[:, i])
        logits, cache = step(jp, jnp.asarray(greedy[:, i:i + 1], jnp.int32),
                             jnp.int32(SS + i), cache)
    np.testing.assert_allclose(arrays[f"{case}/logits{ST}"],
                               np.asarray(logits), rtol=RTOL, atol=ATOL)
    got = {k[len(case) + 7:]: v for k, v in arrays.items()
           if k.startswith(f"{case}/cache/")}
    want = flat_tree(jax.tree.map(np.asarray, cache))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


class _StackedAxis:
    """M ranks' values stacked along the batch dim, reduced as a
    `ModelAxis` would reduce them over M ranks."""

    def __init__(self, m: int):
        self.size = m

    def _over(self, x, op):
        y = op(x.reshape((self.size, -1) + tuple(x.shape[1:])).float())
        return y.repeat((self.size,) + (1,) * (x.dim() - 1)).to(x.dtype)

    def max(self, x):
        return self._over(x, lambda y: y.amax(0))

    def sum(self, x):
        return self._over(x, lambda y: y.sum(0))


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_partial_decode_combines_to_decode_attend(m, window):
    """M ranks' `decode_attend_partial` over their blocks of slots,
    joined by `combine_partials`, against `decode_attend` over the whole
    cache (f32); positions past the end of the ring wrap."""
    rng = np.random.default_rng(m)
    B, C, KV, g, hd = 2, 12, 2, 3, 8
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * g, hd))).float()
    k, v = (torch.from_numpy(rng.standard_normal((B, C, KV, hd))).float()
            for _ in range(2))
    n = C // m
    for pos in ([5, C - 1] if window == 0 else [5, 17, 30]):
        want = attention.decode_attend(q, k, v, pos, window=window)
        parts = [attention.decode_attend_partial(
            q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos,
            lo=r * n, slots=C, window=window) for r in range(m)]
        o = torch.cat([p[0] for p in parts])
        lse = torch.cat([p[1] for p in parts])
        got = attention.combine_partials(o, lse, _StackedAxis(m))
        for r in range(m):
            torch.testing.assert_close(got[r * B:(r + 1) * B], want,
                                       rtol=RTOL, atol=ATOL)


class _Coordinate:
    """A `ModelAxis`'s extent and coordinate, without a group."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank


@pytest.mark.parametrize("heads,kv,m", [(8, 2, 2), (8, 2, 4), (12, 3, 2),
                                        (56, 8, 7)])
def test_each_rank_s_query_heads_read_their_kv_heads(heads, kv, m):
    """`GQASplit.kv_for_heads` from whole k, v: each rank's query heads
    attend (`prefill_attention`, the kernel's plain version here) exactly
    as in the whole attention, whether their groups map to a run of kv
    heads (8/2 over 2), share one (8/2 over 4) or straddle groups unevenly
    (12/3 over 2, llava's 56/8 over 7: one kv head a query head)."""
    rng = np.random.default_rng(heads + m)
    q = torch.from_numpy(rng.standard_normal((1, 16, heads, 8))).float()
    k, v = (torch.from_numpy(rng.standard_normal((1, 16, kv, 8))).float()
            for _ in range(2))
    want = attention.prefill_attention(q, k, v)
    for r in range(m):
        split = tensor_parallel.GQASplit(
            _Coordinate(m, r), heads=True, kv_cols=True, cache="seq",
            slots=16, mlp=True, n_heads=heads)
        lo, hi = split.head_block
        kq, vq = split.kv_for_heads(k, v)
        got = attention.prefill_attention(q[:, :, lo:hi].contiguous(),
                                          kq.contiguous(), vq.contiguous())
        torch.testing.assert_close(got, want[:, :, lo:hi], rtol=RTOL,
                                   atol=ATOL)


class _RankAxis(_Coordinate):
    """Rank `rank` of a model axis of `size` ranks whose sum leaves the
    rank's partial as it is (the test sums the ranks' partials itself)."""

    def sum(self, x):
        return x.to(torch.float32, copy=True).to(x.dtype)


def _moe_block(p: dict, split) -> dict:
    """Rank `split.axis.rank`'s blocks of the MoE params `p`: its experts
    where they split, the shared SwiGLU's w1/w3 columns and w2 rows where
    it does."""
    lo, hi = split.expert_block(p["router"].shape[-1])
    out = {"router": p["router"], **{k: p[k][lo:hi] for k in
                                     ("w1", "w3", "w2")}}
    if "shared" in p:
        sh, m, r = p["shared"], split.axis.size, split.axis.rank
        n = sh["w1"].shape[1] // m if split.mlp else sh["w1"].shape[1]
        a = r * n if split.mlp else 0
        out["shared"] = {"w1": sh["w1"][:, a:a + n],
                         "w3": sh["w3"][:, a:a + n],
                         "w2": sh["w2"][a:a + n]}
    return out


@pytest.mark.parametrize("m,n_experts,n_shared", [(2, 4, 0), (4, 4, 0),
                                                  (2, 8, 1), (4, 6, 0)])
def test_moe_block_form_sums_to_moe_apply(m, n_experts, n_shared):
    """`moe_apply(split=)` on M simulated ranks' blocks (experts E/M a
    rank, the shared SwiGLU's columns; or, where M does not divide E, every
    expert on every rank): the ranks' partial outputs summed are
    `moe_apply`'s output, and their gradients of (y·r).sum() + aux (the
    load-balance loss counted once) summed over the ranks, with each
    rank's expert blocks in place, are its gradients of the router, the
    tokens and every expert, under vmap over a client axis, at a capacity
    that drops assignments; each rank routes every token as the whole
    call does."""
    from repro_torch.models import moe
    rng = np.random.default_rng(m + n_experts)
    N, B, S, d, f, k = 3, 2, 8, 16, 12, 2
    kw = dict(top_k=k, capacity_factor=1.0, aux_coef=0.01)
    p = {"router": 0.3 * rng.standard_normal((d, n_experts)),
         "w1": rng.standard_normal((n_experts, d, f)) / 4,
         "w3": rng.standard_normal((n_experts, d, f)) / 4,
         "w2": rng.standard_normal((n_experts, f, d)) / 3}
    if n_shared:
        p["shared"] = {"w1": rng.standard_normal((d, f * n_shared)) / 4,
                       "w3": rng.standard_normal((d, f * n_shared)) / 4,
                       "w2": rng.standard_normal((f * n_shared, d)) / 5}
    p = tree_map(lambda a: torch.from_numpy(a).float(), p)
    xs = torch.from_numpy(rng.standard_normal((N, B, S, d))).float()
    cots = torch.from_numpy(rng.standard_normal((N, B, S, d))).float()
    split_experts = n_experts % m == 0

    def loss(params, x, cot, split=None, with_aux=True):
        y, aux = moe.moe_apply(params, x, split=split, **kw)
        return (y * cot).sum() + (aux if with_aux else 0.0)

    def table(x, split=None):
        tables = []
        route = moe.route

        def recording(*a):
            r = route(*a)
            tables.append(r.table)
            return r
        moe.route = recording
        try:
            moe.moe_apply(p if split is None else _moe_block(p, split),
                          x, split=split, **kw)
        finally:
            moe.route = route
        return tables[0]

    want_y = vmap(lambda x: moe.moe_apply(p, x, **kw)[0])(xs)
    want_g = vmap(grad(loss, argnums=(0, 1)), in_dims=(None, 0, 0))(
        p, xs, cots)
    want_table = table(xs[0])
    assert (want_table == S * B).any(), "no slot left empty: no drop"
    ys, grads = [], []
    for r in range(m):
        split = tensor_parallel.GQASplit(
            _RankAxis(m, r), heads=False, kv_cols=False, cache="whole",
            slots=0, mlp=bool(n_shared), n_heads=1, experts=split_experts)
        blk = _moe_block(p, split)
        assert blk["w1"].shape[0] == (n_experts // m if split_experts
                                      else n_experts)
        assert torch.equal(table(xs[0], split), want_table)
        ys.append(vmap(lambda x: moe.moe_apply(blk, x, split=split,
                                               **kw)[0])(xs))
        grads.append(vmap(grad(
            lambda q, x, c: loss(q, x, c, split, r == 0 or
                                 not split_experts), argnums=(0, 1)),
            in_dims=(None, 0, 0))(blk, xs, cots))
    if not split_experts:
        # whole experts: every rank computes the whole block
        for y, (gp, gx) in zip(ys, grads):
            torch.testing.assert_close(y, want_y, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(gx, want_g[1], rtol=RTOL, atol=ATOL)
            for a, b in zip(tree_leaves(gp), tree_leaves(want_g[0])):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        return
    torch.testing.assert_close(sum(ys), want_y, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sum(g[1] for g in grads), want_g[1],
                               rtol=RTOL, atol=ATOL)
    gp = [g[0] for g in grads]
    torch.testing.assert_close(sum(g["router"] for g in gp),
                               want_g[0]["router"], rtol=RTOL, atol=ATOL)
    for key in ("w1", "w3", "w2"):
        torch.testing.assert_close(torch.cat([g[key] for g in gp], 1),
                                   want_g[0][key], rtol=RTOL, atol=ATOL)
    if n_shared:
        sh = [g["shared"] for g in gp]
        for key, dim in (("w1", 2), ("w3", 2), ("w2", 1)):
            torch.testing.assert_close(torch.cat([g[key] for g in sh], dim),
                                       want_g[0]["shared"][key], rtol=RTOL,
                                       atol=ATOL)


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


def _meta_params(cfg):
    with FakeTensorMode():
        tree = build_model(cfg).init(0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_training_paths_on_cuda_blocks_raise_naming_12b():
    """A CUDA tensor at model extent > 1 outside what computes on blocks
    raises NotImplementedError naming the ROADMAP entries that remain
    (fake CUDA tensors and a fake mesh: no card and no process group):
    12b took the train step and 12h the federated round, so
    `StepPlacement` of granite, and of olmoe since 12c split its experts,
    holds a split, and the unsplit sequential step handed an update
    constraint and a bare `take` name 12d-12f (12i, the fleets, computes
    on blocks since it was taken); the split steps' blocks are taken."""
    cfg = smoke("granite_3_8b")
    mesh = _FakeMesh(1, 2)
    params = _meta_params(cfg)
    specs = rules.param_specs(params, cfg, mesh)
    olmoe = smoke("olmoe_1b_7b")
    with FakeTensorMode():
        cuda = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cuda"), params)
        assert StepPlacement(cuda, cfg, mesh, 4).split is not None
        moe = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="cuda"),
                       _meta_params(olmoe))
        assert StepPlacement(moe, olmoe, mesh, 4).split.segment(
            0).experts
        step = make_train_step(build_model(cfg), cfg.replace(
            sequential_clients=True), 2, 1,
            update_spec=rules.named(mesh, specs))
        G = tree_map(lambda t: t.new_empty((2,) + tuple(t.shape)), cuda)
        batch = {"tokens": torch.zeros((2, 1, 1, 8), dtype=torch.int32,
                                       device="cuda")}
        with pytest.raises(NotImplementedError, match="entries 12d-12f"):
            step(cuda, G, batch, torch.ones(2, dtype=torch.bool,
                                            device="cuda"), 0.1)
        wq = cuda["segments"]["0"]["attn"]["wq"]
        spec = specs["segments"]["0"]["attn"]["wq"]
        with pytest.raises(NotImplementedError, match="entries 12d-12f"):
            take(wq, spec, mesh)
        assert block_shape(tuple(wq.shape), spec, mesh, wq.device,
                           split=True)[-1] == wq.shape[-1] // 2
        # a mesh of CPU ranks does not carry CUDA blocks, serving or not
        with pytest.raises(NotImplementedError, match="entries 12d-12f"):
            take(wq, spec, _FakeMesh(1, 2, "cpu"), split=True)


@pytest.mark.parametrize("arch,change,mesh,entry", [
    ("olmoe_1b_7b", {"fsdp": True}, (2, 2), "12g"),
    ("deepseek_v2_lite_16b", {}, (1, 2), "12d"),
    ("zamba2_7b", {}, (1, 2), "12e"),
    ("granite_3_8b", {"pad_q_heads": 16, "pad_kv_heads": 16}, (1, 2),
     "12f"),
    ("granite_3_8b", {}, (1, 16), "12f"),
    ("granite_3_8b", {"fsdp": True}, (2, 2), "12g"),
])
def test_what_the_split_leaves_for_later_raises(arch, change, mesh, entry):
    """The serving steps of a config or mesh the split does not take yet
    raise NotImplementedError naming their ROADMAP entry, and the
    planner keeps such plans on the gathering route."""
    cfg = smoke(arch, **change)
    fake = _FakeMesh(*mesh)
    with pytest.raises(NotImplementedError, match=f"entry {entry}"):
        make_prefill_step(build_model(cfg), fake, batch=4, cache_len=32)
    with pytest.raises(NotImplementedError, match=f"entry {entry}"):
        make_decode_step(build_model(cfg), fake, batch=4, cache_len=32)
    assert getattr(plan_config(cfg, "decode_32k", fake).fn, "split",
                   None) is None


def test_plans_split_only_the_serving_steps_on_a_model_axis():
    """On a mesh whose model axis splits, granite's prefill and decode
    plans carry split steps (`launch.specs.run_placed` passes them the
    blocks), and so does its train plan since the train step splits
    (`tests/test_torch_split_train.py`), as do olmoe-1b-7b's and
    moonshot-v1-16b-a3b's, their experts split; every plan on an abstract
    mesh or at model extent 1 keeps the unsplit step."""
    cfg = smoke("granite_3_8b")
    fake = _FakeMesh(1, 2)
    for shape in ("prefill_32k", "decode_32k"):
        split = plan_config(cfg, shape, fake).fn.split
        assert split.segment(0).cache == "heads" and split.head
        for mesh in (make_abstract_mesh((1, 2), ("data", "model")),
                     _FakeMesh(2, 1)):
            assert getattr(plan_config(cfg, shape, mesh).fn, "split",
                           None) is None
    train = plan_config(cfg, "train_4k", fake).fn.split
    assert train.head and train.segment(0).heads and train.embed
    for mesh in (make_abstract_mesh((1, 2), ("data", "model")),
                 _FakeMesh(2, 1)):
        assert getattr(plan_config(cfg, "train_4k", mesh).fn, "split",
                       None) is None
    for arch in ("olmoe_1b_7b", "moonshot_v1_16b_a3b"):
        moe = smoke(arch)
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            split = plan_config(moe, shape, fake).fn.split
            assert split.segment(0).experts and split.segment(0).heads
    assert tensor_parallel.model_axis(None) is None
    step = make_prefill_step(build_model(cfg),
                             make_abstract_mesh((1, 4), ("data", "model")))
    assert getattr(step, "split", None) is None
