"""Public model API (counterpart of `repro/models/model.py`).

`Model` wraps an ArchConfig. Batch formats by modality:
  text:        {'tokens': (B,S) int}
  vision_text: {'tokens': (B,S_text) int, 'patches': (B,P,d)}  (stub frontend)
  audio:       {'frames': (B,S,d), 'labels': (B,S) int}        (stub frontend)
  tabular:     {'x': (B,d) float32, 'y': (B,) int}             (paper models)

Tabular models train (`init`, `loss_fn`, `accuracy`). The zoo's models
train (`loss_fn`, through the differentiable `transformer.forward`) and,
unless encoder-only, serve (`init_cache`, `prefill` and `decode_step`,
through the kernels). A vision_text model (llava-next-34b) takes its P
patch embeddings as a prefix: the sequence is P + S_text positions, the
loss covers the text only and decode continues at P + S_text. An audio
model (hubert-xlarge) projects its frames through `frontend_proj` and
scores every position against its labels. For MoE models (olmoe-1b-7b,
moonshot-v1-16b-a3b, deepseek-v2-lite-16b) `loss_fn` adds the experts'
load-balance loss to the cross-entropy, as the reference does. Params are
nested dicts of tensors under the JAX package's keys, so parity tests
compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (_dense_init, _device_init,
                                       chunked_lm_loss, embed_init,
                                       head_init, rmsnorm, rmsnorm_init,
                                       softmax_cross_entropy)
from repro_torch.sharding.tensor_parallel import gather_model, to_model
from repro_torch.tree import tree_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.param_dtype = DTYPES[cfg.param_dtype]
        self.compute_dtype = DTYPES[cfg.compute_dtype]

    # ------------------------------------------------------------------ #
    # init
    # ------------------------------------------------------------------ #
    def init(self, gen: torch.Generator | int = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Fresh params on `device`. `gen` is a torch.Generator or a seed.
        Tabular models draw on the CPU and move (logistic regression starts
        at zeros, as in the reference); text models draw every leaf on
        `device` from a generator that lives there (a seed makes one)."""
        dev = resolve_device(device)
        cfg = self.cfg
        if cfg.family == "tabular":
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator().manual_seed(int(gen))
            return self._init_tabular(gen, dev)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, params on {dev}: "
                             "text models draw on the params' device")
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                self.param_dtype),
            "final_norm": rmsnorm_init(cfg.d_model, self.param_dtype, dev),
            "lm_head": head_init(gen, cfg.d_model, cfg.vocab_size,
                                 self.param_dtype),
        }
        params.update(transformer.init_segments(gen, cfg, self.param_dtype))
        if cfg.modality == "audio":
            # drawn last, so every other config draws what it drew before
            params["frontend_proj"] = _device_init(
                gen, (cfg.d_model, cfg.d_model), self.param_dtype)
        return params

    def _init_tabular(self, gen: torch.Generator, dev: torch.device) -> dict:
        cfg = self.cfg
        f32 = torch.float32
        if cfg.n_layers == 0:  # logistic regression
            return {"w": torch.zeros((cfg.d_model, cfg.vocab_size), dtype=f32,
                                     device=dev),
                    "b": torch.zeros((cfg.vocab_size,), dtype=f32, device=dev)}
        layers = []
        d_in = cfg.d_model
        for _ in range(cfg.n_layers):
            layers.append({"w": _dense_init(gen, (d_in, cfg.d_ff), f32, dev),
                           "b": torch.zeros((cfg.d_ff,), dtype=f32,
                                            device=dev)})
            d_in = cfg.d_ff
        return {"layers": layers,
                "out": {"w": _dense_init(gen, (d_in, cfg.vocab_size), f32,
                                         dev),
                        "b": torch.zeros((cfg.vocab_size,), dtype=f32,
                                         device=dev)}}

    # ------------------------------------------------------------------ #
    # training loss
    # ------------------------------------------------------------------ #
    def loss_fn(self, params: dict, batch: dict, split=None):
        """(loss, {"loss", "ce", "aux"}): the reference's contract. Text
        models take the shifted-token CE, vision_text models the same over
        the positions after the patches, audio models the CE of every
        position against `labels` (chunked when `cfg.ce_chunk` > 0);
        tabular models take {'x', 'y'}. Under `split`
        (`sharding.tensor_parallel.train_split`) params are this rank's
        blocks and the loss is replicated on the model axis: the layers run
        on the rank's blocks and a vocab-split head takes the cross-entropy
        over the split vocab (`layers.vocab_split_nll`)."""
        cfg = self.cfg
        if cfg.family == "tabular":
            logits = self._tabular_logits(params, batch["x"])
            ce = softmax_cross_entropy(logits, batch["y"])
            return ce, {"loss": ce, "ce": ce, "aux": torch.zeros_like(ce)}
        x = self._embed_inputs(params, batch, split)
        positions = torch.arange(x.shape[1], device=x.device)
        h, aux = transformer.forward(params, x, positions, cfg, split)
        h = rmsnorm(params["final_norm"], h)
        axis = split.axis if split is not None and split.head else None
        if cfg.ce_chunk:
            labels, mask = self._labels_mask(batch)
            ce = chunked_lm_loss(h, params["lm_head"], labels, mask,
                                 chunk=cfg.ce_chunk, axis=axis)
        else:
            if axis is not None:
                h = to_model(h, axis)
            logits = h @ params["lm_head"].to(h.dtype)
            if cfg.modality == "audio":
                ce = softmax_cross_entropy(logits, batch["labels"])
            else:
                P = cfg.n_patches if cfg.modality == "vision_text" else 0
                ce = softmax_cross_entropy(logits[:, P:-1],
                                           batch["tokens"][:, 1:],
                                           axis=axis)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def _labels_mask(self, batch: dict):
        """Full-length labels and validity mask for the chunked CE. Audio:
        `labels`, every position valid. Text: the next token, 0 at the
        end, every position but the last valid; vision_text puts P zero
        labels, invalid, before that."""
        if self.cfg.modality == "audio":
            labels = batch["labels"]
            return labels, torch.ones(labels.shape, device=labels.device)
        tokens = batch["tokens"]
        B, S = tokens.shape
        P = self.cfg.n_patches if self.cfg.modality == "vision_text" else 0
        dev = tokens.device
        labels = torch.cat([torch.zeros((B, P), dtype=tokens.dtype,
                                        device=dev), tokens[:, 1:],
                            torch.zeros_like(tokens[:, :1])], dim=1)
        mask = torch.cat([torch.zeros((B, P), device=dev),
                          torch.ones((B, S - 1), device=dev),
                          torch.zeros((B, 1), device=dev)], dim=1)
        return labels, mask

    def _tabular_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.n_layers == 0:
            return x @ params["w"] + params["b"]
        h = x
        for lp in params["layers"]:
            h = torch.relu(h @ lp["w"] + lp["b"])
        return h @ params["out"]["w"] + params["out"]["b"]

    def accuracy(self, params: dict, batch: dict) -> torch.Tensor:
        logits = self._tabular_logits(params, batch["x"])
        return (logits.argmax(-1) == batch["y"].long()).float().mean()

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #
    def _embed(self, params: dict, tokens: torch.Tensor, split=None
               ) -> torch.Tensor:
        """Token embeddings (B,S,d) in the compute dtype; under `split`
        from this rank's d_model block of `embed`, gathered along d
        (`tensor_parallel.gather_model`: the rank's slice of the cotangent
        in training)."""
        x = params["embed"][tokens.long()].to(self.compute_dtype)
        if split is not None and split.embed:
            x = gather_model(x, -1, split.axis)
        return x

    def _embed_inputs(self, params: dict, batch: dict, split=None
                      ) -> torch.Tensor:
        """The model's input (B,S,d) in the compute dtype: token
        embeddings, after the patches for vision_text (which come in
        replicated under `split`); the frames through `frontend_proj` for
        audio."""
        cdt = self.compute_dtype
        if self.cfg.modality == "audio":
            return batch["frames"].to(cdt) @ params["frontend_proj"].to(cdt)
        x = self._embed(params, batch["tokens"], split)
        if self.cfg.modality == "vision_text":
            x = torch.cat([batch["patches"].to(cdt), x], dim=1)
        return x

    def init_cache(self, batch: int, cache_len: int, *,
                   device: str | torch.device = DEFAULT_DEVICE,
                   split=None) -> dict:
        """Zero caches; under `split` (a `tensor_parallel.ServeSplit`)
        this rank's blocks of them."""
        dev = resolve_device(device)
        if split is None:
            return transformer.init_cache(self.cfg, batch, cache_len,
                                          self.compute_dtype, dev)
        whole = transformer.init_cache(self.cfg, batch, cache_len,
                                       self.compute_dtype, "meta")
        return split.zeros(whole, split.cache_specs, dev)

    def _logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Under split products `lm_head` may be this rank's vocab block:
        the logits are then the rank's block of them."""
        h = rmsnorm(params["final_norm"], h)
        return (h @ params["lm_head"].to(h.dtype))[:, 0]

    def prefill(self, params: dict, batch: dict, cache: dict, split=None):
        """Returns (last-position logits (B,V), cache), the cache filled in
        place. A vision_text batch fills P + S_text positions. Under
        `split` (`sharding.tensor_parallel.serve_split`) params and cache
        are this rank's blocks, and so are the logits where `lm_head`'s
        vocab is split."""
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only")
        x = self._embed_inputs(params, batch, split)
        positions = torch.arange(x.shape[1], device=x.device)
        h, _, cache = transformer.prefill(params, x, positions, cache, cfg,
                                          split)
        return self._logits(params, h[:, -1:]), cache

    def decode_step(self, params: dict, tokens: torch.Tensor, pos: int,
                    cache: dict, split=None):
        """tokens (B,1) int at position `pos` (a Python int). Returns
        (logits (B,V), cache), the cache updated in place. `split` as in
        `prefill`."""
        x = self._embed(params, tokens, split)
        h, _, cache = transformer.decode(params, x, int(pos), cache,
                                         self.cfg, split)
        return self._logits(params, h), cache

    # ------------------------------------------------------------------ #
    def param_count(self, params) -> int:
        return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
