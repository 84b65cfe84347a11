"""Architecture assembly: the decoder LM of the dense, moe, xlstm and
zamba families, and the encoder-decoder.

Counterpart: ``repro/models/model.py`` (``LM``: ``specs``,
``cache_specs``, ``prefill``, ``decode_step``, ``apply``, ``loss``,
``_backbone``; ``EncDec``: ``specs``, ``encode``, ``_dec_embed``,
``apply``, ``loss``, ``cache_specs``, ``prefill``, ``decode_step``;
``build_model``).  The JAX model stacks every layer's parameters with
leading layer dims and runs ``lax.scan`` over them; here the stacked dims
become nested lists and the scans Python loops:

- dense and moe: ``"stack"`` is a list of per-layer dicts (a moe layer
  holds ``"moe"`` in place of ``"mlp"``), the cache a list of per-layer
  ``{"k", "v"}`` dicts;
- xlstm: ``"stack"`` is ``{"m": [[mLSTM layer] x (slstm_every - 1)] x
  groups, "s": [sLSTM layer] x groups}``; each group runs its mLSTM
  layers, then its sLSTM layer.  The cache is ``{"m": [[{"C", "n", "m",
  "conv"}] ...] ..., "s": [{"h", "c", "n", "m"}] x groups}``;
- zamba: ``"stack"`` is ``{"mamba": [[per-layer dict] x shared_every] x
  groups, "shared": one transformer-block dict}``; each group runs its
  mamba layers, then the shared block, which writes that group's own KV
  cache.  The cache is ``{"mamba": [[{"ssm", "conv"}] x shared_every] x
  groups, "shared": [{"k", "v"}] x groups}``;
- encdec (``EncDec``): ``"enc_stack"`` and ``"dec_stack"`` are lists of
  per-layer dicts (a decoder layer also holds ``"ln_cross"`` and
  ``"cross"``); the cache is a list of per-layer ``{"k", "v", "ck",
  "cv"}``, ``"ck"``/``"cv"`` the encoder output's cross K/V
  (``enc_frames`` long).

``apply`` (training) runs every family, as ``_backbone`` does: the dense
and moe layers in order, summing the moe layers' aux (load-balance)
losses; xlstm's and zamba's groups in order.  With ``cfg.remat`` the
counterpart of ``_maybe_remat``'s ``jax.checkpoint`` is
``torch.utils.checkpoint`` (non-reentrant), at the reference's levels:
each dense or moe layer, its aux included; each mLSTM layer; each mamba
layer, and each zamba group around them; each encoder and decoder layer
(the activations are recomputed in the backward pass).

On a mesh with a model axis (the dense, moe and zamba families) ``LM``
runs on this rank's blocks of every parameter and cache leaf
(``core/sharding.py``): the embedding, the logits and the loss are
vocab-parallel where the vocab divides (granite's odd vocab stays whole),
the blocks Megatron's, a moe layer's experts split, a mamba layer on this
rank's heads (``blocks.py``); ``prefill`` and ``decode_step`` return this
rank's vocab columns of the logits (``layers.greedy`` takes their global
argmax, ``layers.gather_vocab`` the whole).  ``partial_mask`` names the
replicated leaves whose gradient is a per-rank part.  Under sequence
parallelism (the hook's ``seq``) the residual between the dense blocks,
and so what ``_remat`` saves of it, is this rank's ``S/M`` rows; the
embedding leaves through a reduce-scatter and the logits take the
gathered sequence after ``ln_f``.

Contract:
  m = build_model(cfg)
  m.specs()                                  ParamSpec tree
  m.apply(params, batch)                  -> (logits, aux)     train fwd
  m.loss(params, batch)                   -> scalar
  m.unread(params)                        -> leaves the loss never reads
  m.cache_specs(batch, cache_len)            ParamSpec tree (zeros init)
  m.prefill(params, batch, cache_len)     -> (last logits, cache)
  m.decode_step(params, cache, batch, pos)-> (logits, cache)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..core.sharding import ParamSpec, is_spec, model_sharded
from . import attention, blocks, layers, ssm

# the families ``LM`` builds; ``EncDec`` builds "encdec"
LM_FAMILIES = ("dense", "moe", "xlstm", "zamba")


def _float_params(sp, cfg):
    """The floating leaves of a spec tree in the config's parameter
    dtype."""
    return pytree.tree_map(
        lambda s: dataclasses.replace(s, dtype=cfg.p_dtype)
        if s.dtype.is_floating_point else s, sp, is_leaf=is_spec)


def _remat(cfg, fn, *args, **kwargs):
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


class LM:
    """Decoder-only LM of the dense, moe, xlstm and zamba families."""

    def __init__(self, cfg):
        if cfg.family not in LM_FAMILIES:
            raise ValueError(f"LM does not build family {cfg.family!r}")
        self.cfg = cfg

    def _groups(self) -> int:
        cfg = self.cfg
        every = cfg.slstm_every if cfg.family == "xlstm" \
            else cfg.shared_every
        return cfg.n_layers // every

    def specs(self) -> dict:
        cfg = self.cfg
        sp = {
            "embed": layers.embed_specs(cfg.vocab, cfg.d_model),
            "ln_f": layers.norm_specs(cfg.d_model, cfg.norm),
            "unembed": layers.unembed_specs(cfg.d_model, cfg.vocab),
        }
        if cfg.family in ("dense", "moe"):
            sp["stack"] = [blocks.tblock_specs(cfg,
                                               use_moe=cfg.family == "moe")
                           for _ in range(cfg.n_layers)]
        elif cfg.family == "xlstm":
            sp["stack"] = {
                "m": [[blocks.mlstm_block_specs(cfg)
                       for _ in range(cfg.slstm_every - 1)]
                      for _ in range(self._groups())],
                "s": [blocks.slstm_block_specs(cfg)
                      for _ in range(self._groups())],
            }
        else:
            sp["stack"] = {
                "mamba": [[blocks.mamba_block_specs(cfg)
                           for _ in range(cfg.shared_every)]
                          for _ in range(self._groups())],
                "shared": blocks.tblock_specs(cfg),
            }
        return _float_params(sp, cfg)

    def _mamba_group(self, x, group, shared):
        """One zamba group: its mamba layers, then the shared block."""
        cfg = self.cfg
        for p in group:
            x = _remat(cfg, blocks.mamba_block_apply, x, p, cfg,
                       chunk=cfg.ssm_chunk)
        return blocks.tblock_apply(x, shared, cfg)[0]

    def apply(self, params, batch):
        """The training forward: (logits [B, S, vocab] in the compute
        dtype, aux loss: the moe layers' sum, 0 for the other families)."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"],
                         cfg.vocab).to(cfg.c_dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe"):
            for p in params["stack"]:
                x, a = _remat(cfg, blocks.tblock_apply, x, p, cfg)
                aux = aux + a
        elif cfg.family == "xlstm":
            for group, sp in zip(params["stack"]["m"], params["stack"]["s"]):
                for p in group:
                    x = _remat(cfg, blocks.mlstm_block_apply, x, p, cfg,
                               chunk=cfg.ssm_chunk)
                x = blocks.slstm_block_apply(x, sp, cfg)
        else:
            shared = params["stack"]["shared"]
            for group in params["stack"]["mamba"]:
                x = _remat(cfg, self._mamba_group, x, group, shared)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"], cfg.vocab), aux

    def loss(self, params, batch):
        lg, aux = self.apply(params, batch)
        return layers.softmax_xent(lg, batch["labels"], batch.get("mask"),
                                   self.cfg.vocab) \
            + self.cfg.aux_weight * aux

    def unread(self, params) -> list:
        """The parameters ``loss`` never reads: none."""
        return []

    def partial_mask(self, specs, ax):
        """A bool tree shaped like ``specs``: True for the replicated
        leaves whose gradient on a rank of the model axis ``ax`` is that
        rank's part, to be summed over the model group: in every
        attention (the dense and moe layers, zamba's shared block)
        ``q_norm``, ``k_norm`` and, when the kv heads do not split,
        ``wk``, ``wv``, ``bk``, ``bv`` (``attention.partial_grad_leaves``);
        in zamba's mamba layers a whole ``in_proj``, ``conv_w``,
        ``conv_b`` beside split heads (``ssm.partial_grad_leaves``).
        Under sequence parallelism (``ax.seq``) that is every leaf the
        rules do not split: the norms and ``b_down`` see this rank's
        rows, and an unsplit product's cut keeps only their gradient."""
        cfg = self.cfg
        if ax.seq:
            return pytree.tree_map(
                lambda s: not model_sharded(ax.mesh, ax.rules, s.shape,
                                            s.dims), specs, is_leaf=is_spec)
        names = attention.partial_grad_leaves(cfg.n_heads, cfg.n_kv_heads,
                                              ax)
        out = pytree.tree_map(lambda s: False, specs, is_leaf=is_spec)

        def mark(node, leaves):
            for n in leaves:
                if n in node:
                    node[n] = True
        if cfg.family in ("dense", "moe"):
            for layer in out["stack"]:
                mark(layer["attn"], names)
        elif cfg.family == "zamba":
            mark(out["stack"]["shared"]["attn"], names)
            mixer = ssm.partial_grad_leaves(cfg, ax)
            for group in out["stack"]["mamba"]:
                for layer in group:
                    mark(layer["mixer"], mixer)
        return out

    def cache_specs(self, batch: int, cache_len: int):
        cfg = self.cfg
        if cfg.family in ("dense", "moe"):
            return [blocks.kv_cache_specs(cfg, batch, cache_len)
                    for _ in range(cfg.n_layers)]
        if cfg.family == "xlstm":
            return {
                "m": [[blocks.mlstm_state_specs(cfg, batch)
                       for _ in range(cfg.slstm_every - 1)]
                      for _ in range(self._groups())],
                "s": [blocks.slstm_state_specs(cfg, batch)
                      for _ in range(self._groups())],
            }
        return {
            "mamba": [[blocks.mamba_state_specs(cfg, batch)
                       for _ in range(cfg.shared_every)]
                      for _ in range(self._groups())],
            "shared": [blocks.kv_cache_specs(cfg, batch, cache_len)
                       for _ in range(self._groups())],
        }

    def prefill(self, params, batch, cache_len: int):
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"],
                         cfg.vocab).to(cfg.c_dtype)
        if cfg.family in ("dense", "moe"):
            cache = []
            for p in params["stack"]:
                x, c = blocks.tblock_prefill(x, p, cfg, cache_len)
                cache.append(c)
        elif cfg.family == "xlstm":
            cache = {"m": [], "s": []}
            for group, sp in zip(params["stack"]["m"], params["stack"]["s"]):
                states = []
                for p in group:
                    x, st = blocks.mlstm_block_prefill(x, p, cfg,
                                                       chunk=cfg.ssm_chunk)
                    states.append(st)
                x, st = blocks.slstm_block_prefill(x, sp, cfg)
                cache["m"].append(states)
                cache["s"].append(st)
        else:
            shared = params["stack"]["shared"]
            cache = {"mamba": [], "shared": []}
            for group in params["stack"]["mamba"]:
                states = []
                for p in group:
                    x, st = blocks.mamba_block_prefill(x, p, cfg,
                                                       chunk=cfg.ssm_chunk)
                    states.append(st)
                x, c = blocks.tblock_prefill(x, shared, cfg, cache_len)
                cache["mamba"].append(states)
                cache["shared"].append(c)
        x = layers.apply_norm(x[:, -1:], params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"], cfg.vocab)[:, 0], cache

    def decode_step(self, params, cache, batch, pos):
        """batch["tokens"]: [B, 1]; pos: scalar int, or a ``[B]`` tensor of
        per-row positions (the recurrent mamba and xLSTM blocks ignore
        it).  Updates the KV caches in place."""
        cfg = self.cfg
        x = layers.embed(batch["tokens"], params["embed"],
                         cfg.vocab).to(cfg.c_dtype)
        if cfg.family in ("dense", "moe"):
            new_cache = []
            for p, c in zip(params["stack"], cache):
                x, c = blocks.tblock_decode(x, p, cfg, c, pos)
                new_cache.append(c)
        elif cfg.family == "xlstm":
            new_cache = {"m": [], "s": []}
            for group, sp, states, sst in zip(
                    params["stack"]["m"], params["stack"]["s"], cache["m"],
                    cache["s"]):
                new_states = []
                for p, st in zip(group, states):
                    x, st = blocks.mlstm_block_decode(x, p, cfg, st, pos)
                    new_states.append(st)
                x, sst = blocks.slstm_block_decode(x, sp, cfg, sst, pos)
                new_cache["m"].append(new_states)
                new_cache["s"].append(sst)
        else:
            shared = params["stack"]["shared"]
            new_cache = {"mamba": [], "shared": []}
            for group, states, kv in zip(params["stack"]["mamba"],
                                         cache["mamba"], cache["shared"]):
                new_states = []
                for p, st in zip(group, states):
                    x, st = blocks.mamba_block_decode(x, p, cfg, st, pos)
                    new_states.append(st)
                x, kv = blocks.tblock_decode(x, shared, cfg, kv, pos)
                new_cache["mamba"].append(new_states)
                new_cache["shared"].append(kv)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"], cfg.vocab)[:, 0], \
            new_cache


class EncDec:
    """Encoder-decoder (whisper-style; the audio frontend is a stub: the
    caller gives precomputed frames [B, S_enc, D]).  The encoder's
    self-attention is non-causal through the flash-attention kernel; the
    decoder's cross K/V are the encoder output projected by each decoder
    layer's ``cross.wk``/``cross.wv`` with no bias."""

    def __init__(self, cfg):
        if cfg.family != "encdec":
            raise ValueError(f"EncDec does not build family {cfg.family!r}")
        self.cfg = cfg

    def specs(self) -> dict:
        cfg = self.cfg
        sp = {
            "embed": layers.embed_specs(cfg.vocab, cfg.d_model),
            "pos_dec": ParamSpec((cfg.max_dec_len, cfg.d_model),
                                 (None, "embed"), init="scaled", scale=0.01),
            "enc_stack": [blocks.tblock_specs(cfg)
                          for _ in range(cfg.n_enc_layers)],
            "ln_enc": layers.norm_specs(cfg.d_model, cfg.norm),
            "dec_stack": [blocks.tblock_specs(cfg, cross=True)
                          for _ in range(cfg.n_layers)],
            "ln_f": layers.norm_specs(cfg.d_model, cfg.norm),
            "unembed": layers.unembed_specs(cfg.d_model, cfg.vocab),
        }
        return _float_params(sp, cfg)

    def encode(self, params, frames):
        """frames: [B, S_enc, D] stub frontend output -> [B, S_enc, D]."""
        cfg = self.cfg
        x = frames.to(cfg.c_dtype)
        x = x + layers.sinusoidal_embedding(
            x.shape[1], cfg.d_model, x.device).to(cfg.c_dtype)[None]
        for p in params["enc_stack"]:
            x = _remat(cfg, blocks.tblock_apply, x, p, cfg, causal=False)[0]
        return layers.apply_norm(x, params["ln_enc"], cfg.norm)

    def _dec_embed(self, params, tokens, pos0=0):
        """Token embeddings plus ``pos_dec`` rows from the scalar ``pos0``
        (clamped so that the rows fit, as ``lax.dynamic_slice`` does)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = layers.embed(tokens, params["embed"]).to(cfg.c_dtype)
        start = min(max(int(pos0), 0), params["pos_dec"].shape[0] - S)
        pe = params["pos_dec"][start:start + S]
        return x + pe.to(cfg.c_dtype)[None]

    @staticmethod
    def _cross_kv(enc, p):
        """One decoder layer's cross K/V [B, S_enc, Hkv, hd] from the
        encoder output, without biases."""
        ck = torch.einsum("bsd,dhk->bshk", enc,
                          p["cross"]["wk"].to(enc.dtype))
        cv = torch.einsum("bsd,dhk->bshk", enc,
                          p["cross"]["wv"].to(enc.dtype))
        return ck, cv

    def _dec_layer(self, x, enc, p):
        return blocks.tblock_apply(x, p, self.cfg,
                                   enc_kv=self._cross_kv(enc, p))[0]

    def apply(self, params, batch):
        """batch: frames [B, S_enc, D], tokens [B, S_dec] -> (logits, a
        float32 zero aux)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._dec_embed(params, batch["tokens"])
        for p in params["dec_stack"]:
            x = _remat(cfg, self._dec_layer, x, enc, p)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"]), \
            torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        lg, _ = self.apply(params, batch)
        return layers.softmax_xent(lg, batch["labels"], batch.get("mask"))

    def unread(self, params) -> list:
        """The parameters ``loss`` never reads: each decoder layer's cross
        ``bk``/``bv``, since the cross K/V are projected without biases
        (``_cross_kv``), as the reference's are."""
        return [p["cross"][n] for p in params["dec_stack"]
                for n in ("bk", "bv") if n in p["cross"]]

    def cache_specs(self, batch: int, cache_len: int) -> list:
        cfg = self.cfg
        out = []
        for _ in range(cfg.n_layers):
            sp = blocks.kv_cache_specs(cfg, batch, cache_len)
            cross = blocks.kv_cache_specs(cfg, batch, cfg.enc_frames)
            sp["ck"], sp["cv"] = cross["k"], cross["v"]
            out.append(sp)
        return out

    def prefill(self, params, batch, cache_len: int):
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._dec_embed(params, batch["tokens"])
        cache = []
        for p in params["dec_stack"]:
            x, c = blocks.tblock_prefill(x, p, cfg, cache_len,
                                         enc_kv=self._cross_kv(enc, p))
            cache.append(c)
        x = layers.apply_norm(x[:, -1:], params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], cache

    def decode_step(self, params, cache, batch, pos):
        """batch["tokens"]: [B, 1]; pos: the scalar position (the decoder's
        position embedding takes one row for the whole batch).  Updates
        the self-attention KV caches in place."""
        cfg = self.cfg
        x = self._dec_embed(params, batch["tokens"], pos0=pos)
        new_cache = []
        for p, c in zip(params["dec_stack"], cache):
            x, c = blocks.tblock_decode(x, p, cfg, c, pos,
                                        enc_kv=(c["ck"], c["cv"]))
            new_cache.append(c)
        x = layers.apply_norm(x, params["ln_f"], cfg.norm)
        return layers.logits(x, params["unembed"])[:, 0], new_cache


def build_model(cfg):
    """``EncDec`` for the encdec family, else ``LM``."""
    return EncDec(cfg) if cfg.family == "encdec" else LM(cfg)
