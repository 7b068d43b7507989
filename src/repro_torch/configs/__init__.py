"""Architecture and input-shape configuration registry.

Counterpart of `repro/configs/__init__.py`: the whole `ArchConfig`, the
input shapes, the name resolution and `all_configs`. Every architecture has
one `<id>.py` here with `CONFIG` (the reference's numbers, `source` kept)
and `smoke()` (its reduced variant): the two paper models and all ten zoo
configs, among them llava-next-34b (vision_text) and hubert-xlarge (audio,
encoder-only), whose frontends are stubs in both packages: the batch
carries the patch or frame embeddings.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


# --------------------------------------------------------------------------- #
# Input shapes (assigned)
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------- #
# Architecture config
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description (the reference's, field for field)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int            # 0 for attention-free (pure ssm)
    n_kv_heads: int
    d_ff: int               # dense-MLP hidden size (0 => no dense MLP, e.g. pure ssm)
    vocab_size: int
    head_dim: int = 0       # 0 => d_model // n_heads

    # --- attention flavour ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True     # False for encoder-only (hubert)
    # sliding-window attention: every `swa_pattern`-th layer is global, rest local
    swa_window: int = 0     # 0 => full attention everywhere
    swa_pattern: int = 0    # e.g. 6 for gemma3's 5 local : 1 global

    # --- MLA (DeepSeek) ---
    kv_lora_rank: int = 0   # 0 => standard GQA
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0      # 0 => dense MLP
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0       # per-expert hidden (defaults to d_ff)
    router_aux_coef: float = 0.01
    first_dense_layers: int = 0  # leading dense layers before MoE layers (DS-V2 style)
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---
    ssm_state: int = 0      # d_state; 0 => no ssm blocks
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (Zamba2) ---
    hybrid_attn_every: int = 0  # insert a *shared* attention block every k-th layer
    shared_attn_window: int = 0  # window the shared attn (long-context serving)

    # --- modality ---
    modality: str = "text"      # text | vision_text | audio
    n_patches: int = 0          # vlm: patch embeddings prepended (stub frontend)
    encoder_only: bool = False

    # --- FL / training defaults ---
    fl_clients: int = 16        # silo clients = data-axis extent for large archs
    fl_local_steps: int = 1
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False          # 2-D (data x model) parameter sharding
    sequential_clients: bool = False  # scan clients (memory) vs vmap (speed)
    # constrain per-client updates to the 2-D G sharding inside the client
    # scan: helps param-heavy archs (qwen), hurts activation-heavy ones
    # (llava) — see EXPERIMENTS.md §Perf H1/H2
    inner_update_constraint: bool = False
    memory_dtype: str = "bfloat16"  # MIFA update-array storage dtype
    ce_chunk: int = 0           # >0: chunked cross-entropy (seq chunk size)
    # pad attention heads (compute-layout only, params untouched) so the head
    # count divides the TP axis — avoids XLA splitting head_dim (which turns
    # the score contraction into partial sums all-reduced at score size)
    pad_q_heads: int = 0
    pad_kv_heads: int = 0

    # --- citation ---
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_layer_arch(self) -> bool:
        return self.ssm_state > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def supports_long_decode(self) -> bool:
        """long_500k needs sub-quadratic attention (or no attention)."""
        if self.encoder_only:
            return False
        if self.ssm_state > 0:  # ssm & hybrid
            return True
        return self.swa_window > 0  # SWA-dense (gemma3)

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'local_attn' | 'ssm' | 'shared_attn'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm",):
                kinds.append("ssm")
            elif self.family == "hybrid":
                # zamba2: mamba2 backbone, shared attention block every k layers
                if self.hybrid_attn_every and (i % self.hybrid_attn_every
                                               == self.hybrid_attn_every - 1):
                    kinds.append("shared_attn")
                else:
                    kinds.append("ssm")
            elif self.swa_pattern:
                # gemma3: (pattern-1) local layers then 1 global, repeating
                kinds.append("attn" if (i % self.swa_pattern
                                        == self.swa_pattern - 1) else "local_attn")
            else:
                kinds.append("attn")
        return kinds

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

ARCH_IDS = [
    "moonshot_v1_16b_a3b",
    "deepseek_v2_lite_16b",
    "mamba2_1_3b",
    "gemma3_4b",
    "olmoe_1b_7b",
    "zamba2_7b",
    "qwen1_5_110b",
    "granite_3_8b",
    "llava_next_34b",
    "hubert_xlarge",
]

# map the assignment's dashed ids to module names
_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-1.3b": "mamba2_1_3b",
    "gemma3-4b": "gemma3_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-7b": "zamba2_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-3-8b": "granite_3_8b",
    "llava-next-34b": "llava_next_34b",
    "hubert-xlarge": "hubert_xlarge",
})

# paper-scale configs also live here
PAPER_IDS = ["paper_logistic", "paper_mlp"]


def canonical_id(arch: str) -> str:
    """Module name of `arch` (dashed, dotted or underscored); raises
    KeyError for an unknown name."""
    key = arch.strip()
    if key not in ARCH_IDS and key not in PAPER_IDS:
        key = _ALIAS.get(key, key.replace("-", "_").replace(".", "_"))
    if key in ARCH_IDS or key in PAPER_IDS:
        return key
    raise KeyError(f"unknown architecture {arch!r}; known: "
                   f"{ARCH_IDS + PAPER_IDS}")


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.smoke()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
