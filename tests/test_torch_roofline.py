"""The port's roofline (`roofline/analysis.py`) and dry-run driver
(`launch/dryrun.py`) against the JAX package's, on the CPU.

* `count_params` equals the reference's for every arch (total, and active:
  the MoE experts' inactive share and the embedding table left out).
* `model_flops` and `roofline_terms` equal the reference's on the same
  inputs: every arch x input shape with the reference's counts, and
  random analysis dicts under both packages' hardware tables.
* `analyze_plan`: per-rank argument bytes equal the whole bytes over the
  extents the reference's specs name; a decode plan's traced FLOPs equal
  its matmuls counted by hand; the client axis' all-reduce bytes follow
  the docstring's count.
* The CLI, run in-process with `--out tmp_path`: mamba2-1.3b decode_32k on
  the pod mesh is ok on 256 chips with the reference's `params_total` and
  a bottleneck; hubert-xlarge decode_32k is a skip naming encoder-only;
  nothing is written under `benchmarks/`.

The reference's `launch/dryrun.py` sets XLA_FLAGS when imported (512 host
devices); `_ref_dryrun` imports it and puts the variable back, so no other
test in this process sees the change.
"""
import importlib
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.launch.mesh import make_abstract_mesh as jax_mesh
from repro.roofline import analysis as jana
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.roofline import analysis
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _ref_dryrun():
    """The reference's `repro.launch.dryrun`, imported with XLA_FLAGS put
    back as it was."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_the_reference_s(arch):
    assert dryrun.count_params(arch) == _ref_dryrun().count_params(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference_s(arch):
    total, active = _ref_dryrun().count_params(arch)
    for name, shape in INPUT_SHAPES.items():
        for kind in ("train", "prefill", "encode", "decode"):
            assert analysis.model_flops(
                get_config(arch), total, active, shape, kind) == \
                jana.model_flops(jax_config(arch), total, active,
                                 jspecs.INPUT_SHAPES[name], kind)


def test_roofline_terms_equal_the_reference_s():
    rng = np.random.default_rng(0)
    for hw in (analysis.HW, jana.HW):
        for _ in range(50):
            a = {k: float(10 ** rng.uniform(0, 15)) for k in (
                "hlo_flops_parsed", "cost_analysis_flops",
                "hlo_bytes_parsed", "cost_analysis_bytes",
                "collective_bytes_total")}
            if rng.random() < 0.3:        # parsing found nearly nothing
                a["hlo_flops_parsed"] = 0.0
            assert analysis.roofline_terms(a, hw) == jana.roofline_terms(a,
                                                                         hw)
    assert analysis.HW["peak_flops"] == 989e12
    assert analysis.HW["hbm_bw"] == 3.35e12
    assert "H100" in analysis.HW["card"]


@pytest.mark.parametrize("arch,shape", [("granite_3_8b", "decode_32k"),
                                        ("llava_next_34b", "train_4k"),
                                        ("hubert_xlarge", "prefill_32k")])
def test_argument_bytes_follow_the_reference_s_specs(arch, shape):
    """Per-rank bytes of every argument: its whole bytes over the extents
    of the mesh axes its reference spec names (no trace)."""
    mesh = ((2, 16, 16), ("pod", "data", "model"))
    sizes = dict(zip(mesh[1], mesh[0]))
    ref = jspecs.plan(arch, shape, jax_mesh(*mesh))
    port = specs.plan(arch, shape, make_abstract_mesh(*mesh))
    want = 0
    for sds, ns in zip(jax.tree.leaves(ref.args), jax.tree.leaves(
            ref.in_shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        split = 1
        for entry in ns.spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                split *= sizes.get(a, 1)
        want += int(np.prod(sds.shape)) * sds.dtype.itemsize // split
    assert analysis.per_rank_bytes(port.args, port.in_shardings) == want


def test_decode_flops_are_its_matmuls():
    """A 2-layer granite decode plan's traced FLOPs, counted by hand: the
    four projections, the MLP's three matmuls, Q·Kᵀ and P·V over the whole
    cache, and the head."""
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    cfg = get_config("granite_3_8b").replace(n_layers=2)
    p = specs.plan_config(cfg, "decode_32k", mesh)
    B, C = p.meta["batch"], p.meta["cache_len"]
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    layer = (2 * B * d * (H + 2 * KV) * hd + 2 * B * H * hd * d
             + 3 * 2 * B * d * cfg.d_ff + 2 * 2 * B * H * C * hd)
    want = cfg.n_layers * layer + 2 * B * d * cfg.vocab_size
    ops, _ = analysis.trace(p)
    assert sum(ops.values()) == want
    a = analysis.analyze_plan(p, mesh)
    assert a["flops_traced"] == want == a["hlo_flops_parsed"]
    mem = a["memory"]
    assert mem["alias_bytes"] == sum(
        t.numel() * t.element_size()
        for t in tree_leaves(p.args[1]))
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                         + mem["output_bytes"]
                                         - mem["alias_bytes"])


def test_client_collective_bytes_count():
    """A vmap train plan whose clients the data axis splits all-reduces
    4 B a parameter and 8 B of scalars a round; a 1-rank data axis, a
    sequential plan and a serving plan issue none."""
    cfg = get_config("granite_3_8b").replace(n_layers=1)
    n_params = sum(t.numel() for t in tree_leaves(
        specs.param_shapes(cfg)))
    for mesh, want in ((((4, 2), ("data", "model")), 4 * n_params + 8),
                       (((1, 2), ("data", "model")), 0)):
        m = make_abstract_mesh(*mesh)
        p = specs.plan_config(cfg, "train_4k", m)
        assert analysis.client_collective_bytes(p, m) == (
            {"all-reduce": float(want)} if want else {})
    m = make_abstract_mesh((4, 2), ("data", "model"))
    seq = specs.plan_config(get_config("qwen1_5_110b").replace(n_layers=1),
                            "train_4k", m)
    dec = specs.plan_config(cfg, "decode_32k", m)
    assert analysis.client_collective_bytes(seq, m) == {}
    assert analysis.client_collective_bytes(dec, m) == {}


def test_dryrun_cli_records_a_plan_and_a_skip(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2_1_3b", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2_1_3b__decode_32k__pod.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["n_chips"] == 256
    assert (rec["params_total"], rec["params_active"]) == \
        _ref_dryrun().count_params("mamba2_1_3b")
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["step_time_lower_bound_s"] > 0
    assert rec["analysis"]["memory"]["peak_estimate_bytes"] > 0
    assert rec["analysis"]["params_placement"] == analysis.PARAMS_PLACEMENT
    assert "sharding.params" in rec["analysis"]["params_placement"]
    assert rec["hw"]["card"] == analysis.HW["card"]
    dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "hubert_xlarge__decode_32k__pod.json")
                     .read_text())
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]
    assert "dry-run summary: 0 ok / 1 skip / 0 fail" in capsys.readouterr(
        ).out
    # the default output is git-ignored build/, never benchmarks/
    default = Path(dryrun.ARTIFACT_DIR).resolve()
    assert default == ROOT / "build" / "dryrun"
