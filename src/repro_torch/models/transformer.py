"""Config-driven decoder LM (torch; a port of ``repro/models/transformer.py``
for the block kinds the port runs).

JAX scans each segment's superblock over parameters stacked on a leading
``rep`` axis; here the model is an ``nn.Module`` with one submodule per
layer, in the order the scan visits them (for each repeat, each block of
the superblock).  Weights carried from JAX are unstacked by
``repro_torch.convert.lm_params_from_arrays``.

Ported: every block kind JAX's ``build_segments`` makes.  ``gqa``
attention (causal, full or over a sliding window as in gemma3's local
layers; with or without qk_norm) with a ``dense`` SwiGLU FFN, the
cross-attention block of llama-3.2-vision and whisper's decoder (``ln_x``
/ ``xattn`` after the self-attention, over ``cross_kv_x``, with no RoPE),
hymba's block (``attn`` and ``ssm`` on the same normed input, averaged,
then the dense FFN; ``models/ssm.py``), xLSTM's FFN-less ``mlstm`` /
``slstm`` blocks (``ln1`` and ``core``; ``models/xlstm_blocks.py``),
deepseek-v3's ``mla`` attention (``models/mla.py``) and the ``moe`` FFN of
kimi-k2 and deepseek-v3 (``models/moe.py``), whose first
``cfg.first_k_dense`` layers keep the dense FFN; and an LM head tied to
the embedding (logits ``x @ embed.T``) or untied (a ``head`` weight
[d_model, vocab], logits ``x @ head``).  A MoE block runs
``moe.moe_dense`` under ``moe_impl="dense"`` (the default, as in JAX) and,
under ``"a2a"``, ``moe.moe_a2a`` over the model's ``mesh`` in prefill and
``moe.moe_local`` in decode; its router's aux loss is the ``aux`` that
:meth:`DecoderLM.forward` sums over layers (0 without MoE blocks).  An MLA
block's decode cache is its latent ``c`` and ``k_rope``.  A windowed
layer's decode cache is a ring buffer of ``min(window, seq_len)`` slots,
as in JAX; a cross block's cache
adds ``xk`` / ``xv`` of ``cross_len`` slots (``cfg.n_vision_tokens`` by
default, as in JAX), zeros until :meth:`DecoderLM.fill_cross_caches`
writes the projected source into them in place; a hymba block's adds its
fp32 SSM state ``ssm``, an mLSTM block's is ``C``, ``n``, ``m`` and an
sLSTM block's ``c``, ``n``, ``h``, ``m`` (fp32; ``m`` starts at -1e30),
all written in place by a decode step.  ``cfg.remat`` is JAX's activation
checkpointing of each segment's scan body, one superblock repeat (its
``cross_kv_x`` passed as an argument, so that its gradient survives): under
"full" (the default, and any value but "dots" and "none", as in JAX's
``_remat``) a repeat keeps only its input and recomputes the rest in the
backward (``torch.utils.checkpoint``, non-reentrant); under "dots" it
keeps the outputs of its 2-D products (``aten.mm`` / ``aten.addmm``: the
projections and the FFN) and recomputes the rest, JAX's
``dots_with_no_batch_dims_saveable``; "none" keeps every activation.  It
applies only when a gradient is wanted (grad mode on and a parameter
that requires one), so serving and prefill are unchanged; the flash
kernel's forward then runs twice a step, the backward's attention
recompute (``attention._FlashAttention``) once.  Losses and gradients
are the same bits under every policy.  Parameters are created with
``requires_grad=False`` (serving needs no graph);
``steps.init_train_state`` turns gradients on.

Public surface:
  DecoderLM(cfg, device, seed, moe_impl, mesh) — random weights from a seed
  forward(tokens, positions, cross_kv_x) — prefill logits, aux
  hidden(tokens, positions, cross_kv_x)  — final-norm hidden states
  init_cache / decode_step              — KV / state caches, one token
  fill_cross_caches(cache, src)         — cross caches from a source
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as A
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from . import xlstm_blocks as XL
from .config import ModelConfig
from .layers import dense_init, rms_norm, swiglu, swiglu_init


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    attn: str = "gqa"        # gqa | mla | hymba | mlstm | slstm
    ffn: str = "dense"       # dense | moe | none
    window: int = 0          # sliding-window size (0 = full attention)
    cross_attn: bool = False


def build_segments(cfg: ModelConfig) -> List[Tuple[Tuple[BlockSpec, ...],
                                                   int]]:
    """Architecture pattern -> [(superblock, repeat)]."""
    if cfg.xlstm:
        pair = (BlockSpec(attn="mlstm", ffn="none"),
                BlockSpec(attn="slstm", ffn="none"))
        assert cfg.n_layers % 2 == 0
        return [(pair, cfg.n_layers // 2)]
    if cfg.ssm_heads:  # hymba: parallel attn+ssm heads every layer
        return [((BlockSpec(attn="hymba", window=cfg.local_window),),
                 cfg.n_layers)]
    attn = "mla" if cfg.mla else "gqa"
    ffn_main = "moe" if cfg.is_moe else "dense"
    segs: List[Tuple[Tuple[BlockSpec, ...], int]] = []
    if cfg.attn_pattern == "local_global":
        r = cfg.local_global_ratio
        sb = tuple([BlockSpec(attn=attn, ffn=ffn_main,
                              window=cfg.local_window)] * (r - 1)
                   + [BlockSpec(attn=attn, ffn=ffn_main)])
        rem = cfg.n_layers % r
        if rem:
            segs.append(((BlockSpec(attn=attn, ffn=ffn_main,
                                    window=cfg.local_window),), rem))
        segs.append((sb, cfg.n_layers // r))
        return segs
    if cfg.is_moe and cfg.first_k_dense:
        segs.append(((BlockSpec(attn=attn, ffn="dense"),),
                     cfg.first_k_dense))
        segs.append(((BlockSpec(attn=attn, ffn="moe"),),
                     cfg.n_layers - cfg.first_k_dense))
        return segs
    if cfg.cross_attn_every:
        k = cfg.cross_attn_every
        assert cfg.n_layers % k == 0
        sb = tuple([BlockSpec(attn=attn)] * (k - 1)
                   + [BlockSpec(attn=attn, cross_attn=True)])
        return [(sb, cfg.n_layers // k)]
    return [((BlockSpec(attn=attn, ffn=ffn_main),), cfg.n_layers)]


def layer_specs(cfg: ModelConfig) -> List[BlockSpec]:
    """The block of every layer, in the order JAX's scan applies them."""
    return [spec for sb, rep in build_segments(cfg) for _ in range(rep)
            for spec in sb]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(p: Dict[str, Any]) -> nn.ParameterDict:
    """Frozen parameters of a dict; a nested dict (a MoE block's
    ``shared``) becomes a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: _frozen_dict(v) if isinstance(v, dict) else _frozen(v)
        for k, v in p.items()})


class Block(nn.Module):
    """One block of ``spec`` — JAX ``block_init``'s pytree with the same
    names, shapes and dtypes: ``ln1``, then for gqa ``attn`` (wq, wk, wv,
    wo[, q_norm, k_norm]), for hymba ``attn`` and ``ssm`` (w_in, w_bc,
    w_dt, dt_bias, A_log, D, w_out), for mla ``attn`` (w_dq, q_norm, w_uq,
    w_dkv, kv_norm, w_uk, w_uv, wo), for mlstm / slstm ``core``; with
    ``spec.cross_attn`` also ``ln_x`` and ``xattn`` (wq, wk, wv, wo; K / V
    from d_model wide sources); with a dense FFN ``ln2``, ``mlp`` (wi, wg,
    wo); with a MoE FFN ``ln2``, ``moe`` (router, wi, wg, wo[, shared]),
    its experts E-major (``models/moe.py``)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device, spec: BlockSpec = BlockSpec()) -> None:
        super().__init__()
        dt, d = cfg.torch_dtype, cfg.d_model
        self.ln1 = _frozen(torch.zeros(d, dtype=dt, device=device))
        if spec.attn in ("gqa", "hymba"):
            self.attn = _frozen_dict(A.attn_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
                qk_norm=cfg.qk_norm, device=device))
        if spec.attn == "hymba":
            self.ssm = _frozen_dict(SSM.ssm_init(
                gen, d, cfg.ssm_heads, d // cfg.ssm_heads, cfg.ssm_state, dt,
                device=device))
        elif spec.attn == "mla":
            self.attn = _frozen_dict(MLA.mla_init(gen, cfg, dt,
                                                  device=device))
        elif spec.attn == "mlstm":
            self.core = _frozen_dict(XL.mlstm_init(gen, d, cfg.n_heads, dt,
                                                   device=device))
        elif spec.attn == "slstm":
            self.core = _frozen_dict(XL.slstm_init(gen, d, cfg.n_heads, dt,
                                                   device=device))
        if spec.cross_attn:
            self.ln_x = _frozen(torch.zeros(d, dtype=dt, device=device))
            self.xattn = _frozen_dict(A.attn_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
                kv_input_dim=d, device=device))
        if spec.ffn == "dense":
            self.ln2 = _frozen(torch.zeros(d, dtype=dt, device=device))
            self.mlp = _frozen_dict(swiglu_init(gen, d, cfg.d_ff, dt,
                                                device=device))
        elif spec.ffn == "moe":
            self.ln2 = _frozen(torch.zeros(d, dtype=dt, device=device))
            self.moe = _frozen_dict(MOE.moe_init(
                gen, d, cfg.d_ff_moe, cfg.n_experts, dt,
                n_shared=cfg.n_shared_experts, device=device))


# --------------------------------------------------------------------------- #
# Block apply / cache / decode
# --------------------------------------------------------------------------- #
def _moe_ffn(cfg: ModelConfig, bp: Block, x: torch.Tensor, moe_impl: str,
             mesh, decode: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of one block on ``rms_norm(x, ln2)``: (y, aux)."""
    h = rms_norm(x, bp.ln2, cfg.norm_eps)
    if moe_impl == "dense":
        return MOE.moe_dense(bp.moe, h, cfg.top_k)
    # Decode's few tokens are not split by sequence: every entry keeps its
    # own experts' assignments and no buffer moves (JAX's moe_local).
    fn = MOE.moe_local if decode else MOE.moe_a2a
    return fn(bp.moe, h, cfg.top_k, cfg.capacity_factor, mesh)


def block_apply(cfg: ModelConfig, spec: BlockSpec, bp: Block,
                x: torch.Tensor, positions: Optional[torch.Tensor],
                cross_kv_x: Optional[torch.Tensor] = None,
                moe_impl: str = "dense", mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) application.  Returns (x, aux): the MoE
    router's aux loss, or 0 for a block with no MoE FFN."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, bp.ln1, eps)
    if spec.attn == "mla":
        x = x + MLA.mla_attention(bp.attn, cfg, h, positions,
                                  chunk=cfg.attn_chunk)
    elif spec.attn in ("gqa", "hymba"):
        a = A.attention(bp.attn, h, positions, window=spec.window,
                        rope_theta=cfg.rope_theta, eps=eps,
                        chunk=cfg.attn_chunk)
        if spec.attn == "hymba":
            scan = (SSM.ssm_scan_ssd if cfg.ssm_impl == "ssd"
                    else SSM.ssm_scan)
            a = 0.5 * (a + scan(bp.ssm, h, cfg.ssm_state))
        x = x + a
    elif spec.attn == "mlstm":
        x = x + XL.mlstm_scan(bp.core, h)
    elif spec.attn == "slstm":
        x = x + XL.slstm_scan(bp.core, h)
    if spec.cross_attn:
        h = rms_norm(x, bp.ln_x, eps)
        x = x + A.attention(bp.xattn, h, positions, kv_x=cross_kv_x,
                            causal=False, use_rope=False, eps=eps)
    if spec.ffn == "dense":
        x = x + swiglu(bp.mlp, rms_norm(x, bp.ln2, eps))
    elif spec.ffn == "moe":
        y, aux = _moe_ffn(cfg, bp, x, moe_impl, mesh, decode=False)
        x = x + y
    return x, aux


def block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     seq_len: int, device=None,
                     cross_len: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Decode cache for one block: for gqa and hymba, K and V for
    ``seq_len`` positions, or for a windowed block ``min(window,
    seq_len)`` slots used as a ring buffer (position p in slot p %
    slots), and hymba's zeroed fp32 SSM state ``ssm`` [B, ssm_heads,
    d_model / ssm_heads, ssm_state]; mLSTM's ``C``, ``n``, ``m`` and
    sLSTM's ``c``, ``n``, ``h``, ``m`` (fp32, ``m`` filled with -1e30); a
    cross block also has zeroed ``xk`` / ``xv`` of ``cross_len`` slots
    (``cfg.n_vision_tokens`` when None or 0, as in JAX); MLA's zeroed
    latent ``c`` [B, seq_len, kv_lora] and ``k_rope`` [B, seq_len,
    qk_rope]."""
    d, nh = cfg.d_model, cfg.n_heads
    if spec.attn == "mla":
        return MLA.mla_cache_init(batch, seq_len, cfg, cfg.torch_dtype,
                                  device)
    if spec.attn == "mlstm":
        return XL.mlstm_decode_init(batch, nh, int(d * 2.0) // nh, device)
    if spec.attn == "slstm":
        return XL.slstm_decode_init(batch, nh, d // nh, device)
    s = min(spec.window, seq_len) if spec.window else seq_len
    c = A.init_cache(batch, s, cfg.n_kv_heads, cfg.hd, cfg.torch_dtype,
                     device=device)
    if spec.attn == "hymba":
        c["ssm"] = SSM.ssm_decode_init(batch, cfg.ssm_heads,
                                       d // cfg.ssm_heads, cfg.ssm_state,
                                       device)
    if spec.cross_attn:
        x = A.init_cache(batch, cross_len or cfg.n_vision_tokens,
                         cfg.n_kv_heads, cfg.hd, cfg.torch_dtype,
                         device=device)
        c["xk"], c["xv"] = x["k"], x["v"]
    return c


def block_decode(cfg: ModelConfig, spec: BlockSpec, bp: Block,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos: Union[int, torch.Tensor], moe_impl: str = "dense",
                 mesh=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one block; the caches are written in place."""
    eps = cfg.norm_eps
    h = rms_norm(x, bp.ln1, eps)
    if spec.attn == "mlstm":
        return x + XL.mlstm_decode_step(bp.core, h, cache)[0], cache
    if spec.attn == "slstm":
        return x + XL.slstm_decode_step(bp.core, h, cache)[0], cache
    if spec.attn == "mla":
        a, cache = MLA.mla_decode_step(bp.attn, cfg, h, cache, pos)
    else:
        a, cache = A.decode_attention(bp.attn, h, cache, pos,
                                      window=spec.window,
                                      rope_theta=cfg.rope_theta, eps=eps)
    if spec.attn == "hymba":
        s, _ = SSM.ssm_decode_step(bp.ssm, h, cache["ssm"], cfg.ssm_state)
        a = 0.5 * (a + s)
    x = x + a
    if spec.cross_attn:
        h = rms_norm(x, bp.ln_x, eps)
        a, _ = A.decode_attention(bp.xattn, h,
                                  {"k": cache["xk"], "v": cache["xv"]},
                                  pos, cross=True, eps=eps)
        x = x + a
    if spec.ffn == "dense":
        x = x + swiglu(bp.mlp, rms_norm(x, bp.ln2, eps))
    elif spec.ffn == "moe":
        x = x + _moe_ffn(cfg, bp, x, moe_impl, mesh, decode=True)[0]
    return x, cache


# The 2-D products a "dots" policy saves: the projections and the FFN
# (``attention._proj`` / ``_out_proj``, ``layers.swiglu``) lower to them;
# attention's batched products (``bmm``) are recomputed, as JAX's policy
# saves only dots with no batch dimensions.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` checkpointed under a ``cfg.remat`` policy (JAX's
    ``_remat``)."""
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


# --------------------------------------------------------------------------- #
class DecoderLM(nn.Module):
    """The decoder LM with its weights.  ``seed`` seeds a
    ``torch.Generator`` on ``device`` from which every weight is drawn
    with the JAX initializers' scales; on the ``meta`` device nothing is
    drawn (shapes only).  ``moe_impl`` ("dense" or "a2a") and ``mesh`` (a
    ``launch.mesh.DeviceMesh``, which "a2a" needs) are JAX's
    ``DecoderLM(cfg, moe_impl, mesh)``: how the MoE blocks run."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 moe_impl: str = "dense", mesh=None) -> None:
        super().__init__()
        if moe_impl not in ("dense", "a2a"):
            raise ValueError(f"moe_impl must be 'dense' or 'a2a', got "
                             f"{moe_impl!r}")
        if moe_impl == "a2a" and mesh is None:
            raise ValueError("moe_impl='a2a' needs a mesh")
        self.cfg = cfg
        self.moe_impl, self.mesh = moe_impl, mesh
        self.specs = layer_specs(cfg)
        device = torch.device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        dt, d = cfg.torch_dtype, cfg.d_model
        self.embed = _frozen(dense_init(gen, cfg.vocab, d, dt, std=0.02,
                                        device=device))
        self.final_norm = _frozen(torch.zeros(d, dtype=dt, device=device))
        # JAX draws the untied head right after the embedding, with the
        # default d_model ** -0.5 scale.
        self.head = (None if cfg.tie_embeddings else
                     _frozen(dense_init(gen, d, cfg.vocab, dt,
                                        device=device)))
        self.layers = nn.ModuleList(Block(cfg, gen, device, s)
                                    for s in self.specs)
        # Layer ranges of JAX's scan bodies: one superblock repeat each.
        self.repeats: List[Tuple[int, int]] = []
        for sb, rep in build_segments(cfg):
            for _ in range(rep):
                lo = self.repeats[-1][1] if self.repeats else 0
                self.repeats.append((lo, lo + len(sb)))

    # -- forward (prefill) ---------------------------------------------- #
    def hidden(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cross_kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-norm hidden states [B, T, D] of tokens [B, T]; the cross
        blocks attend to ``cross_kv_x`` [B, S, D] (JAX's; None runs them
        as non-causal self-attention, as JAX does)."""
        return self._hidden_aux(tokens, positions, cross_kv_x)[0]

    def _hidden_aux(self, tokens, positions, cross_kv_x
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(:meth:`hidden`, the aux losses summed in layer order)."""
        x = self.embed[tokens.long()]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        wanted = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        body = _remat(self._repeat, self.cfg.remat if wanted else "none")
        for lo, hi in self.repeats:
            x, aux = body(x, aux, lo, hi, positions, cross_kv_x)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def _repeat(self, x: torch.Tensor, aux: torch.Tensor, lo: int, hi: int,
                positions: Optional[torch.Tensor],
                cross_kv_x: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layers [lo, hi): one superblock repeat, JAX's scan body."""
        for spec, bp in zip(self.specs[lo:hi], self.layers[lo:hi]):
            x, a = block_apply(self.cfg, spec, bp, x, positions, cross_kv_x,
                               self.moe_impl, self.mesh)
            aux = aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cross_kv_x: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, T, vocab], aux): aux sums the MoE blocks' router
        losses (0 without MoE blocks)."""
        x, aux = self._hidden_aux(tokens, positions, cross_kv_x)
        return self._logits(x), aux

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.head is None:
            return torch.matmul(x, self.embed.t())      # tied head
        return torch.matmul(x, self.head)

    # -- decode --------------------------------------------------------- #
    def init_cache(self, batch: int, seq_len: int,
                   cross_len: Optional[int] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """One cache dict per layer (JAX stacks them per segment), zeroed
        but for the xLSTM stabilizers' -1e30; cross blocks' ``xk`` /
        ``xv`` hold ``cross_len`` slots."""
        dev = self.embed.device
        return [block_cache_init(self.cfg, spec, batch, seq_len, device=dev,
                                 cross_len=cross_len)
                for spec in self.specs]

    @torch.no_grad()
    def fill_cross_caches(self, cache: List[Dict[str, torch.Tensor]],
                          src: torch.Tensor) -> None:
        """Write ``src`` [B, S, D] projected through each cross block's
        ``xattn`` wk / wv (cast to the cache dtype) into its ``xk`` /
        ``xv`` in place, so that a captured decode step reads them.  JAX
        has no such function: its decode starts from zeroed caches, and
        its test fills them with this projection."""
        for spec, bp, lc in zip(self.specs, self.layers, cache):
            if spec.cross_attn:
                lc["xk"].copy_(A._proj(src, bp.xattn["wk"]))
                lc["xv"].copy_(A._proj(src, bp.xattn["wv"]))

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    token: torch.Tensor, pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """token [B,1] int; pos: an int or a 0-d integer tensor on the
        model's device (``attention.decode_attention``).  Returns
        (logits [B,1,vocab], cache), the caches written in place."""
        x = self.embed[token.long()]
        for spec, bp, lc in zip(self.specs, self.layers, cache):
            x, _ = block_decode(self.cfg, spec, bp, x, lc, pos,
                                self.moe_impl, self.mesh)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), cache
