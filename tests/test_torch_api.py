"""The port's package surface against the JAX package's: names each exports,
and the `verbose=` progress lines of the run functions.

* `core` exports `ScanDriver` and `scan_supported`; `fleet` exports
  `FleetScanDriver` and `fleet_scan_supported`; `data` exports
  `TokenBatcher` and `make_token_stream`; `launch.steps` the step
  builders; `configs` serves qwen1.5-110b. Each name imports from both
  packages.
* Names and signatures: every public function and class of the walked
  modules of the JAX package (`launch.mesh`, `sharding.rules`,
  `core.runner`, `core.scan_engine`, `fleet.executor`, `bank.dense`,
  `launch.specs`, `launch.dryrun`, `roofline.analysis`) is in
  the port's module of the same name with the reference's parameters, in
  order, up to the listed torch forms; the JAX-only names are listed with
  the reason.
* `run_fl` (loop and scan), `run_fleet` (loop and scan), `run_sim_scan`
  (through `run_fl(sim=)`) and `run_sim_fleet` take `verbose=` and print,
  at each eval, the reference's line (`repro/core/runner.py:715`,
  `core/scan_engine.py:398`, `fleet/executor.py:641` and `:764`,
  `sim/compiled.py:323`, `fleet/sim.py:186`), held here with the numbers
  masked, against the reference's own lines for the runner's loop.
"""
import importlib
import inspect
import os
import re
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core import BernoulliParticipation, BiasedFedAvg, run_fl
from repro_torch.data import ClientBatcher
from repro_torch.fleet import (SimTrial, Trial, make_fleet_eval, run_fleet,
                               run_sim_fleet)
from repro_torch.models import build_model
from repro_torch.optim import inv_t
from repro_torch.scenarios import Bernoulli
from repro_torch.sim import SimConfig, SimSpec, TraceLatency, WaitForAll
from test_torch_sim import _data

torch.set_num_threads(1)

NAMES = [("core", "ScanDriver"), ("core", "scan_supported"),
         ("fleet", "FleetScanDriver"), ("fleet", "fleet_scan_supported"),
         ("data", "TokenBatcher"), ("data.synthetic", "make_token_stream"),
         ("launch.steps", "make_train_step"),
         ("launch.steps", "make_decode_step"),
         ("launch.steps", "make_prefill_step"),
         ("launch.steps", "make_encoder_step"),
         ("models.layers", "chunked_lm_loss"),
         ("models.attention", "blockwise_attention"),
         ("models.ssm", "ssd_chunked"), ("models.transformer", "forward"),
         ("configs.qwen1_5_110b", "CONFIG")]


@pytest.mark.parametrize("module,name", NAMES,
                         ids=[f"{m}.{n}" for m, n in NAMES])
def test_name_imports_from_both_packages(module, name):
    for pkg in ("repro", "repro_torch"):
        assert hasattr(importlib.import_module(f"{pkg}.{module}"), name), \
            (pkg, module, name)


WALKED = ["launch.mesh", "sharding.rules", "core.runner", "core.scan_engine",
          "fleet.executor", "bank.dense", "launch.specs", "launch.dryrun",
          "roofline.analysis"]
# the compiled program's HLO text, which only XLA gives
_HLO = ("reads XLA's optimized HLO text of a compiled program; the port "
        "compiles none and analyzes a plan by tracing it "
        "(roofline.analysis.analyze_plan)")
# public names of the walked reference modules with no counterpart
JAX_ONLY = {
    **{f"roofline.analysis.{name}": _HLO
       for name in ("parse_hlo", "analyze_compiled", "Op", "Computation")},
    "core.runner.warn_legacy_threefry":
        "warns when JAX's legacy threefry lowering, whose bits depend on "
        "the sharding, is on; the port draws only the partitionable "
        "stream (scenarios._threefry), whose masks do not",
    **{f"core.runner.{name}": "a pure round function the reference jits; "
       "the port's round is core.runner.make_round_body's"
       for name in ("make_dense_round_fn", "make_cohort_update_fn",
                    "make_scenario_round_fn", "make_scan_round_fn",
                    "make_cohort_round_fn")}}
# parameters only the port takes ("*": every name), and why
_STACKED = "a fleet's stacked initial params, as run_fl(params=)"
PORT_ONLY_PARAMS = {
    "*": {"device": "every entry point takes the run's device"},
    "fleet.executor.FleetRunner": {"params": _STACKED},
    "fleet.executor.run_fleet": {"params": _STACKED},
    "launch.dryrun.main": {"argv": "the CLI's arguments, so a caller runs "
                                   "it in-process"}}
# parameters only the reference takes, by name, and why
JAX_ONLY_PARAMS = {"bank.dense.DenseBank": {
    "use_pallas": "a kernel wrapper decides by its tensor's device"}}


def _params(obj) -> list:
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("module", WALKED)
def test_names_and_signatures_walk(module):
    # the reference's launch/dryrun.py sets XLA_FLAGS when imported: put
    # it back, so no later test in this process sees 512 host devices
    before = os.environ.get("XLA_FLAGS")
    try:
        ref = importlib.import_module(f"repro.{module}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    port = importlib.import_module(f"repro_torch.{module}")
    for name, obj in vars(ref).items():
        if (name.startswith("_") or getattr(obj, "__module__", None)
                != ref.__name__ or not (inspect.isfunction(obj)
                                        or inspect.isclass(obj))):
            continue
        key = f"{module}.{name}"
        if key in JAX_ONLY:
            assert not hasattr(port, name), key
            continue
        assert hasattr(port, name), key
        dropped = JAX_ONLY_PARAMS.get(key, {})
        added = {**PORT_ONLY_PARAMS["*"], **PORT_ONLY_PARAMS.get(key, {})}
        assert ([p for p in _params(obj) if p not in dropped]
                == [p for p in _params(getattr(port, name))
                    if p not in added]), key


def test_qwen_config_is_the_reference_s():
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config
    assert asdict(get_config("qwen1.5-110b")) == asdict(
        jax_config("qwen1.5-110b"))
    assert asdict(get_smoke_config("qwen1.5-110b")) == asdict(
        jax_smoke("qwen1.5-110b"))


N, ROUNDS, EVERY = 9, 5, 2
CONFIG = SimConfig(epoch_s=4.0, server_overhead_s=0.1,
                   max_lookahead_epochs=40)


def _problem():
    cfg, X, y, idx = _data()
    model = build_model(cfg)
    batcher = ClientBatcher(X, y, idx, batch_size=8, k_steps=2, seed=0)
    test = {"x": torch.from_numpy(X[:64]).float(),
            "y": torch.from_numpy(y[:64])}

    def eval_fn(params):
        with torch.no_grad():
            loss, _ = model.loss_fn(params, test)
            return float(loss), float(model.accuracy(params, test))

    return model, batcher, eval_fn, test


def _lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


def _masked(lines) -> list:
    return [re.sub(r"-?\d+(\.\d+)?", "#", ln) for ln in lines]


def _kw(model, batcher):
    return dict(model=model, batcher=batcher, schedule=inv_t(1.0),
                n_rounds=ROUNDS, eval_every=EVERY, verbose=True,
                device="cpu")


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_run_fl_verbose_prints_the_reference_s_lines(engine, capsys):
    import jax

    from repro.core import BernoulliParticipation as JBernoulli
    from repro.core import BiasedFedAvg as JBiasedFedAvg
    from repro.core import run_fl as jax_run_fl
    from repro.data import ClientBatcher as JClientBatcher
    from repro.models import build_model as jax_build
    from repro_torch.convert import params_from_jax
    model, batcher, eval_fn, test = _problem()
    cfg, X, y, idx = _data()
    jmodel = jax_build(model.cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jtest = {k: v.numpy() for k, v in test.items()}
    jax_run_fl(model=jmodel, algo=JBiasedFedAvg(),
               batcher=JClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                      seed=0),
               schedule=inv_t(1.0), n_rounds=ROUNDS, eval_every=EVERY,
               participation=JBernoulli(np.full(N, 0.6), seed=5),
               eval_fn=lambda p: tuple(map(float, (
                   jmodel.loss_fn(p, jtest)[0], jmodel.accuracy(p, jtest)))),
               params=jparams, engine=engine, verbose=True)
    ref = _lines(capsys)
    kw = _kw(model, batcher)
    run_fl(algo=BiasedFedAvg(), eval_fn=eval_fn, engine=engine,
           participation=BernoulliParticipation(np.full(N, 0.6), seed=5),
           params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
           **kw)
    got = _lines(capsys)
    assert [ln.split()[:2] for ln in got] == [["round", str(t)]
                                              for t in (0, 2, 4)]
    assert _masked(got) == _masked(ref)
    # the same evals, to the printed digits
    assert [ln.split("acc=")[0] for ln in got] == \
        [ln.split("acc=")[0] for ln in ref]


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_run_fleet_verbose(engine, capsys):
    model, batcher, _, test = _problem()
    trials = [Trial(seed=s, participation=BernoulliParticipation(
        np.full(N, 0.6), seed=5 + s)) for s in (0, 1)]
    run_fleet(algo=BiasedFedAvg(), trials=trials, engine=engine,
              eval_fn=make_fleet_eval(model, test, device="cpu"),
              **_kw(model, batcher))
    assert _masked(_lines(capsys)) == ["  round     # loss=# acc=#"] * 3


def test_sim_runs_verbose(capsys):
    model, batcher, eval_fn, test = _problem()
    lat = TraceLatency(np.ones((1, N)), device="cpu")
    run_fl(algo=BiasedFedAvg(), eval_fn=eval_fn, engine="scan",
           scenario=Bernoulli(0.6, n=N, seed=5),
           sim=SimSpec(policy=WaitForAll(), latency=lat,
                       config=CONFIG), **_kw(model, batcher))
    assert _masked(_lines(capsys)) == [
        "  round     # sim_t=      #s train=# eval=# acc=#"] * 3
    kw = _kw(model, batcher)
    del kw["verbose"]
    run_sim_fleet(algo=BiasedFedAvg(), trials=[SimTrial(
        seed=s, policy=WaitForAll(), scenario=Bernoulli(0.6, n=N, seed=s),
        latency=lat) for s in (0, 1)], config=CONFIG,
        eval_fn=make_fleet_eval(model, test, device="cpu"), verbose=True,
        **kw)
    assert _masked(_lines(capsys)) == [
        "  round     # sim_t=      #s loss=# acc=#"] * 3
