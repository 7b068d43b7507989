"""The port stands alone and never runs quietly on the wrong device.

* No module of `src/repro_torch` and not `chip_smoke.py` imports `jax`,
  anything of the JAX package `repro`, or `ml_dtypes` (the card's machine
  has neither JAX nor `ml_dtypes`).
* Entry points default to device="cuda" and raise without a GPU unless the
  caller passes device="cpu".
* What the slice leaves for later raises NotImplementedError naming it.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bank import DenseBank, PagedDeviceBank
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import MIFA, BernoulliParticipation, run_fl
from repro_torch.data import ClientBatcher
from repro_torch.fleet import (FleetRunner, Trial, make_fleet_eval,
                               run_fleet)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import constant
from repro_torch.scenarios import make_scenario

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_round.py",
    ROOT / "scripts" / "profile_serve.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path,
                                                                   name)


def test_isolation_walk_sees_the_whole_port():
    mods = {p.stem for p in PORT_FILES}
    assert {"runner", "mifa", "dense", "paged_device", "mifa_aggregate",
            "bank_scatter", "paged_bank", "pipeline", "ops", "backend",
            "baselines", "sgd", "spec", "executor", "chip_smoke",
            "flash_attention", "ssd_scan", "attention", "ssm",
            "transformer", "layers", "model", "convert", "serve",
            "zamba2_7b", "mamba2_1_3b", "granite_3_8b", "profile_serve",
            "scan_engine", "quantized_memory", "int8_paged",
            "participation", "_threefry", "processes", "registry",
            "algorithms", "host", "events", "latency", "policies",
            "engine", "compiled", "sim", "io", "run_state",
            "trace_replay", "elastic", "train", "steps",
            "qwen1_5_110b", "mesh", "rules", "specs", "dryrun",
            "analysis", "introspect"} <= mods
    assert "jax" in _imported_modules(ROOT / "tests" / "test_torch_model.py")


def _tiny(cfg):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    idx = np.array_split(np.arange(40), 4)
    return ClientBatcher(X, y, idx, batch_size=4, k_steps=2)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks what happens without a GPU")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = get_smoke_config("paper_logistic")
    model = build_model(cfg)
    kw = dict(model=model, algo=MIFA(), batcher=_tiny(cfg),
              schedule=constant(0.1), n_rounds=1,
              participation=BernoulliParticipation(np.full(4, 0.5)))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        run_fl(**kw)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        DenseBank()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        PagedDeviceBank()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    fleet = dict(model=model, algo=MIFA(), batcher=kw["batcher"],
                 schedule=constant(0.1))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        run_fleet(**fleet, n_rounds=1, trials=[
            Trial(seed=0, participation=kw["participation"])])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        FleetRunner(**fleet, seeds=(0, 1))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make_fleet_eval(model, {"x": np.zeros((2, 64), np.float32)})
    # the simulator and the host bank (ROADMAP Queue 1 items 16 and 9)
    from repro_torch.bank import HostBank
    from repro_torch.data import JitProceduralBatcher
    from repro_torch.fleet import SimTrial, run_sim_fleet
    from repro_torch.sim import (LognormalLatency, TraceLatency, WaitForAll,
                                 tiered_shifted_exponential)
    for make in (HostBank, lambda: tiered_shifted_exponential(4),
                 lambda: TraceLatency(np.ones((2, 4))),
                 lambda: LognormalLatency(0.0, 0.5, n=4),
                 lambda: JitProceduralBatcher(n_clients=4, dim=3,
                                              batch_size=2, k_steps=1)):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make()
    lat = TraceLatency(np.ones((2, 4)), device="cpu")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        lat.sample(0, device="cuda")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        run_sim_fleet(**fleet, n_rounds=1, trials=[SimTrial(
            seed=0, policy=WaitForAll(),
            scenario=make_scenario("bernoulli", n=4), latency=lat)])


def test_cpu_run_takes_the_plain_path():
    cfg = get_smoke_config("paper_logistic")
    params, hist = run_fl(model=build_model(cfg), algo=MIFA(),
                          batcher=_tiny(cfg), schedule=constant(0.1),
                          n_rounds=3,
                          participation=BernoulliParticipation(np.full(4, .5)),
                          device="cpu")
    assert params["w"].device.type == "cpu" and len(hist.train_loss) == 3


# items of this table that have since been ported: their option now runs
# (for item 19, mesh= of item 19b)
PORTED_ITEMS = {"12", "13", "16", "17", "19"}


def _sim_spec():
    from repro_torch.sim import SimSpec, WaitForAll, TraceLatency
    return SimSpec(policy=WaitForAll(),
                   latency=TraceLatency(np.ones((1, 4)), device="cpu"))


@pytest.mark.parametrize("kw,item", [
    ({"scenario": make_scenario("gilbert_elliott", n=4)}, "13"),
    ({"sim": _sim_spec()}, "16"), ({"checkpoint": "spec"}, "17"),
    ({"mesh": "1x1"}, "19"), ({"engine": "scan"}, "12")])
def test_unported_run_options_raise(kw, item, tmp_path):
    cfg = get_smoke_config("paper_logistic")
    # a scenario takes the place of the participation process
    avail = ({} if "scenario" in kw else {"participation":
                                          BernoulliParticipation(
                                              np.full(4, 0.5))})
    if "checkpoint" in kw:
        # checkpoints ride the scan engine's chunk cuts
        from repro_torch.checkpoint import CheckpointSpec
        kw = {"checkpoint": CheckpointSpec(every=1, dir=str(tmp_path)),
              "engine": "scan"}
    if "mesh" in kw:
        # meshes place the scan engine's carry
        from repro_torch.launch.mesh import make_abstract_mesh
        kw = {"mesh": make_abstract_mesh((1, 1), ("data", "model")),
              "engine": "scan"}

    def run():
        return run_fl(model=build_model(cfg), algo=MIFA(),
                      batcher=_tiny(cfg), schedule=constant(0.1), n_rounds=1,
                      device="cpu", **avail, **kw)

    if item in PORTED_ITEMS:
        assert len(run()[1].train_loss) == 1
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        run()


def test_unported_modules_raise():
    from repro_torch.bank import HostBank, make_bank
    # the host bank (item 9) is ported
    assert isinstance(make_bank("host", device="cpu"), HostBank)
    # MLA (item 18.3), the stub frontends (18.4), update_spec= and the
    # params' placement over mesh axes (item 19) are ported: an update
    # constraint that splits leaves over an abstract mesh places nothing,
    # and the step runs whole (here on fake tensors, as the dry run
    # traces it; llava cut to 1 layer of full width)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.specs import param_shapes
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("llava_next_34b").replace(n_layers=1)
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    specs = rules.param_specs(param_shapes(cfg), cfg, mesh)
    assert rules.sharded_axes(specs, mesh) == {"data", "model"}
    model = build_model(cfg)
    step = make_train_step(model, cfg, 2, 1,
                           update_spec=rules.named(mesh, specs))
    with FakeTensorMode():
        params = model.init(0, device="cpu")
        G = tree_map(lambda p: torch.zeros((2,) + tuple(p.shape),
                                           dtype=torch.float32), params)
        batch = {"tokens": torch.zeros((2, 1, 1, 8), dtype=torch.int32),
                 "patches": torch.zeros((2, 1, 1, cfg.n_patches,
                                         cfg.d_model), dtype=torch.bfloat16)}
        new, G, metrics = step(params, G, batch, torch.tensor([True, False]),
                               0.1)
    assert [p.shape for p in tree_leaves(new)] == [
        p.shape for p in tree_leaves(params)]
    assert metrics["loss"].shape == ()


def test_serving_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.launch import train
    from repro_torch.launch.serve import serve
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        serve("zamba2-7b", smoke=True)
    # training (ROADMAP Queue 1 item 18.5): the function and its CLI
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        train.train("granite-3-8b", smoke=True, rounds=1)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        train.main(["--arch", "granite-3-8b", "--smoke", "--rounds", "1"])
    model = build_model(get_smoke_config("zamba2-7b"))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        model.init_cache(1, 8)


def test_serve_on_cpu_takes_the_plain_kernels():
    from repro_torch.launch.serve import serve
    out = serve("zamba2-7b", smoke=True, batch=2, prompt_len=16,
                new_tokens=3, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["logits"].shape == (2, 512)
    assert bool(torch.isfinite(out["logits"].float()).all())
    zero = {"flash_attention": 0, "ssd_scan": 0}
    assert out["launches"] == {"prefill": zero, "decode": zero}


@pytest.mark.parametrize("arch,change", [
    ("granite_3_8b", {"swa_window": 8, "swa_pattern": 2}),     # local_attn
    ("granite_3_8b", {"kv_lora_rank": 16}),                    # mla
    ("granite_3_8b", {"n_experts": 4, "top_k": 2}),            # moe
    ("granite_3_8b", {"modality": "vision_text", "n_patches": 4}),
    ("granite_3_8b", {"modality": "audio"}),
    ("zamba2_7b", {"shared_attn_window": 8})])
def test_unported_block_kinds_and_modalities_raise(arch, change):
    """Every block kind and modality is ported: windows (local_attn and a
    windowed shared attention, item 18.1), MoE (item 18.2), MLA (item
    18.3) and the stub frontends (item 18.4) build and run a training loss
    on their modality's batch and, unless encoder-only, a served
    prefill (a vision_text cache holds the patches too)."""
    cfg = get_smoke_config(arch).replace(**change)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.zeros((1, 12), dtype=torch.long)
    batch, n_pos = {"tokens": toks}, 12
    if cfg.modality == "vision_text":
        batch["patches"] = torch.zeros((1, cfg.n_patches, cfg.d_model))
        n_pos += cfg.n_patches
    elif cfg.modality == "audio":
        batch = {"frames": torch.ones((1, 12, cfg.d_model)), "labels": toks}
    loss, _ = model.loss_fn(params, batch)
    assert bool(torch.isfinite(loss))
    if cfg.modality == "audio":
        return
    logits, _ = model.prefill(params, batch,
                              model.init_cache(1, n_pos, device="cpu"))
    assert logits.shape == (1, cfg.vocab_size)


def test_unported_zoo_surfaces_raise():
    from repro_torch.launch.serve import main
    from repro_torch.models import transformer
    # every zoo config is ported: qwen1.5-110b (item 18.0), the text
    # training path (18.5), gemma3-4b (18.1), the MoE configs (18.2),
    # deepseek-v2-lite-16b (18.3), llava-next-34b and hubert-xlarge (18.4)
    assert get_config("llava-next-34b").n_patches == 2880
    assert get_config("hubert_xlarge").encoder_only
    assert get_config("qwen1.5-110b").qkv_bias
    assert get_config("gemma3-4b").swa_window == 1024
    assert get_config("olmoe-1b-7b").n_experts == 64
    assert get_config("moonshot-v1-16b-a3b").top_k == 6
    assert get_config("deepseek-v2-lite-16b").kv_lora_rank == 512
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gpt5")
    cfg = get_smoke_config("granite-3-8b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    loss, aux = model.loss_fn(params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long)})
    assert bool(torch.isfinite(loss)) and set(aux) == {"loss", "ce", "aux"}
    x, _ = transformer.forward(params, torch.zeros(
        (1, 4, cfg.d_model), dtype=torch.bfloat16), torch.arange(4), cfg)
    assert x.shape == (1, 4, cfg.d_model)
    mla = cfg.replace(kv_lora_rank=16)
    x, _ = transformer.forward(build_model(mla).init(0, device="cpu"), x,
                               torch.arange(4), mla)
    assert x.shape == (1, 4, cfg.d_model)
    # --params (item 17) is ported: it loads a snapshot, which must exist
    with pytest.raises(FileNotFoundError):
        main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
              "--params", "no-such-snapshot.npz"])
