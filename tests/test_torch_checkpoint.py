"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's, on the CPU.

* `save_pytree` / `load_pytree` round-trip nested dicts and lists, dict
  keys that look numeric, bf16 leaves and the `.npz` suffix; a snapshot
  written by either package loads in the other array-equal (bf16 by its
  bits: uint16 views plus the key list on the port's host side, torch bf16
  with `as_torch`); a write that dies midway leaves the previous snapshot
  intact and no temp file behind.
* `CheckpointSpec`'s validation is the reference's.
* `PagedDeviceBank.host_state` after the same evicting cohorts as the
  reference's bank: the same keys, the bookkeeping array-equal, spilled
  pages equal (copies, as `tests/test_torch_paged_bank.py` holds pages);
  a bank loaded from it (or from the reference's state) pages on exactly
  as the original.
* `serve --params --smoke --device cpu` from a port snapshot, and from a
  reference snapshot converted through `convert.params_from_jax`, gives
  the tokens of the in-memory params.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.bank import PagedDeviceBank as JPagedDeviceBank
from repro.checkpoint import CheckpointSpec as JCheckpointSpec
from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.bank import PagedDeviceBank
from repro_torch.checkpoint import CheckpointSpec, load_pytree, save_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def _tree():
    rng = np.random.default_rng(0)
    return {"a": torch.arange(6).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.float64),
                       "c": [torch.zeros(2, dtype=torch.int8),
                             torch.from_numpy(rng.normal(size=3).astype(
                                 np.float32))]},
            "segments": {"0": {"w": torch.tensor([1.5, -2.25],
                                                 dtype=torch.bfloat16)},
                         "1": torch.tensor(True)},
            "t": torch.tensor(7, dtype=torch.int32)}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_roundtrip_nested_numeric_keys_and_bf16(tmp_path):
    tree = _tree()
    p = save_pytree(str(tmp_path / "ck"), tree)          # suffix appended
    assert p == str(tmp_path / "ck.npz") and os.path.exists(p)
    back = load_pytree(p, device="cpu")
    assert isinstance(back["nested"]["c"], list)
    assert set(back["segments"]) == {"0", "1"}           # dicts stay dicts
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        _same(a, b)
    host = load_pytree(p, as_torch=False)
    w = host["segments"]["0"]["w"]
    assert w.dtype == np.uint16
    np.testing.assert_array_equal(
        w, tree["segments"]["0"]["w"].view(torch.int16).numpy().view(
            np.uint16))
    assert host["__bf16_keys__"].tolist() == ["segments/0/w"]
    assert "__bf16_keys__" not in load_pytree(
        save_pytree(str(tmp_path / "plain.npz"), {"x": torch.ones(2)}),
        as_torch=False)


def test_port_snapshot_loads_in_reference_and_back(tmp_path):
    tree = _tree()
    p = save_pytree(str(tmp_path / "port.npz"), tree)
    ref = jload_pytree(p, as_jax=False)
    assert ref["segments"]["0"]["w"].dtype == ml_dtypes.bfloat16
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(ref)):
        want = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        np.testing.assert_array_equal(np.asarray(b, want.dtype), want)
    # the reference's snapshot of the same numpy values (jnp would narrow
    # the 64-bit leaves), read by the port
    q = jsave_pytree(str(tmp_path / "ref"), ref)
    back = load_pytree(q, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        _same(a, b)


def test_atomic_save_survives_torn_write(tmp_path, monkeypatch):
    p = str(tmp_path / "ck.npz")
    save_pytree(p, {"a": torch.arange(3)})

    def torn_savez(f, **arrays):
        f.write(b"PK\x03\x04 partial garbage")
        raise OSError("disk gone")

    monkeypatch.setattr(np, "savez", torn_savez)
    with pytest.raises(OSError, match="disk gone"):
        save_pytree(p, {"a": torch.arange(3) * 100})
    monkeypatch.undo()
    _same(load_pytree(p, device="cpu")["a"], torch.arange(3))
    assert os.listdir(tmp_path) == ["ck.npz"]


@pytest.mark.parametrize("kw,match", [({"every": 0}, "every"),
                                      ({"every": 1, "keep": 0}, "keep")])
def test_checkpoint_spec_validation(kw, match):
    for spec in (CheckpointSpec, JCheckpointSpec):
        with pytest.raises(ValueError, match=match):
            spec(dir="x", **kw)
    ok = CheckpointSpec(every=3, dir="x", keep=2, resume=True)
    assert (ok.every, ok.keep, ok.resume) == (3, 2, True)


def test_load_pytree_defaults_to_cuda(tmp_path, monkeypatch):
    p = save_pytree(str(tmp_path / "ck"), {"a": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        load_pytree(p)
    assert load_pytree(p, as_torch=False)["a"].dtype == np.float32


# --------------------------------------------------------------------------- #
# the paged bank's host state
# --------------------------------------------------------------------------- #

N = 8
EVICT_COHORTS = [[0, 1], [4, 5], [2, 3], [0, 5], [6, 7], [1, 2], [4], [0, 7]]


def _params():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _updates(t, n):
    rng = np.random.default_rng((3, t))
    return {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _run_both(dt, cohorts):
    jb = JPagedDeviceBank(page_size=2, n_slots=2, dtype=dt, use_pallas=False)
    tb = PagedDeviceBank(page_size=2, n_slots=2, dtype=dt, device="cpu")
    js = jb.init(jax.tree.map(jnp.asarray, _params()), N)
    ts = tb.init(_to_torch(_params()), N)
    for t, ids in enumerate(cohorts):
        ids = np.array(ids)
        upd = _updates(t, len(ids))
        js = jb.scatter(js, ids, jax.tree.map(jnp.asarray, upd))
        ts = tb.scatter(ts, ids, _to_torch(upd))
    return (jb, js), (tb, ts)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_host_state_matches_reference(tmp_path, dt):
    (jb, js), (tb, ts) = _run_both(dt, EVICT_COHORTS[:6])
    got, ref = tb.host_state(), jb.host_state()
    assert list(got) == list(ref)
    for k in ref:
        if k != "spill":
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]), err_msg=k)
    assert len(got["spill"]) == len(ref["spill"]) > 0
    for a, b in zip(got["spill"], ref["spill"]):
        assert list(a) == list(b) == ["pages"]
        for x, y in zip(a["pages"], b["pages"]):
            np.testing.assert_array_equal(_f32(x), _f32(y))
    # through a snapshot: a fresh bank loaded from it pages on exactly as
    # the original through the remaining cohorts
    p = save_pytree(str(tmp_path / "bank"), {"bank": got, "state": ts})
    snap = load_pytree(p, as_torch=False)
    assert (dt == "bfloat16") == ("bank/spill/#0/pages/#0" in set(
        np.asarray(snap.get("__bf16_keys__", [])).tolist()))
    nb = PagedDeviceBank(page_size=2, n_slots=2, dtype=dt, device="cpu")
    nb.init(_to_torch(_params()), N)
    nb.load_host_state(snap["bank"])
    ns = load_pytree(p, device="cpu")["state"]
    for t, ids in enumerate(EVICT_COHORTS[6:], start=6):
        upd = _to_torch(_updates(t, len(ids)))
        ns = nb.scatter(ns, np.array(ids), upd)
        ts = tb.scatter(ts, np.array(ids), upd)
    assert (nb.faults, nb.evictions) == (tb.faults, tb.evictions)
    np.testing.assert_array_equal(nb._pt, tb._pt)
    assert nb._free == tb._free and sorted(nb._spill) == sorted(tb._spill)
    for a, b in zip(tree_leaves(nb.gather(ns, np.arange(N))),
                    tree_leaves(tb.gather(ts, np.arange(N)))):
        assert torch.equal(a, b)
    nb.check_invariants(ns)
    # the reference's host state loads too, into the same bookkeeping
    rb = PagedDeviceBank(page_size=2, n_slots=2, dtype=dt, device="cpu")
    rb.init(_to_torch(_params()), N)
    rb.load_host_state(ref)
    np.testing.assert_array_equal(rb._pt, np.asarray(ref["pt"]))
    assert rb._free == list(ref["free"]) and rb._clock == ref["clock"]
    for lp, entry in zip(ref["spill_lp"], ref["spill"]):
        for a, b in zip(rb._spill[int(lp)], entry["pages"]):
            assert a.dtype == rb.dtype
            np.testing.assert_array_equal(_f32(a), _f32(b))


def test_host_state_int8_pages_keep_their_scales():
    tb = PagedDeviceBank(page_size=2, n_slots=2, dtype="int8", device="cpu")
    ts = tb.init(_to_torch(_params()), N)
    gen = torch.Generator().manual_seed(0)
    for t, ids in enumerate(EVICT_COHORTS[:6]):
        ts = tb.scatter(ts, np.array(ids), _to_torch(_updates(t, len(ids))),
                        rng=gen)
    host = tb.host_state()
    entry = host["spill"][0]
    assert [b.dtype for b in entry["pages"]] == [torch.int8, torch.int8]
    assert [b.dtype for b in entry["scales"]] == [torch.float32] * 2
    nb = PagedDeviceBank(page_size=2, n_slots=2, dtype="int8", device="cpu")
    nb.init(_to_torch(_params()), N)
    nb.load_host_state(jax.tree.map(np.asarray, {
        k: v for k, v in host.items() if k != "spill"}) | {
            "spill": [{k: [b.numpy() for b in v] for k, v in e.items()}
                      for e in host["spill"]]})
    for lp, blocks in tb._spill.items():
        for a, b in zip(blocks, nb._spill[lp]):
            assert torch.equal(a, b)
    nb.load_host_state({})                      # a bank without host state
    assert nb._clock == tb._clock


# --------------------------------------------------------------------------- #
# serving from a snapshot
# --------------------------------------------------------------------------- #

SERVE = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--batch",
         "2", "--prompt-len", "8", "--new-tokens", "4"]


def test_serve_params_from_port_and_reference_snapshots(tmp_path):
    cfg = get_smoke_config("granite-3-8b")
    want = serve(cfg=cfg, batch=2, prompt_len=8, new_tokens=4,
                 device="cpu")["tokens"]
    params = build_model(cfg).init(0, device="cpu")
    p = save_pytree(str(tmp_path / "port"), params)
    got = serve_main(SERVE + ["--params", p])
    assert torch.equal(got["tokens"], want)
    # a reference snapshot: its params carried over by params_from_jax
    jparams = jax_build(jax_smoke("granite-3-8b")).init(
        jax.random.PRNGKey(0))
    q = jsave_pytree(str(tmp_path / "ref"), jparams)
    from_ref = serve_main(SERVE + ["--params", q])
    direct = serve(cfg=cfg, batch=2, prompt_len=8, new_tokens=4,
                   device="cpu", params=params_from_jax(
                       jload_pytree(q, as_jax=False), "cpu"))
    assert torch.equal(from_ref["tokens"], direct["tokens"])
    for a, b in zip(tree_leaves(load_pytree(q, device="cpu")),
                    jax.tree.leaves(jparams)):
        want_b = np.asarray(b, np.float32)
        np.testing.assert_array_equal(a.float().numpy(), want_b)
