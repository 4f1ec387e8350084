"""Flash attention: block-wise online-softmax attention.

Replaces ``repro.kernels.flash_attention._flash_kernel`` (the Pallas TPU
kernel behind ``repro.kernels.ops.flash_attention(impl="pallas")``).  The
function both versions compute, in the layout the reference keeps at its
public function:

  q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q's dtype;
  query head h reads kv head ``h // (H / Hkv)`` (GQA, ``jnp.repeat``'s
  order); query i sits at position ``i + q_offset``; scores are
  ``(q . k) * scale`` in f32, masked to ``-1e30`` where a key is at or
  past ``kv_len``, after the query (``causal``) or ``window`` or more
  positions behind it; running ``(acc, m, l)`` in f32, masked
  probabilities forced to 0, ``l`` clamped at 1e-30, so a fully masked
  row comes out 0.

  * ``flash_attention_kernel`` launches the hand-written Hopper kernel
    (``csrc/flash_attention.cu``) on CUDA tensors and counts its
    launches in ``flash_attention_kernel.launches``;
  * ``flash_attention_plain`` is the plain PyTorch version (the same
    online softmax over key blocks), which CPU tensors take.

What bounds it on the H100: at the prefill's causal 32768 x 32768 the
QK^T and PV products (4·D flops per unmasked query-key pair and head) on
the bf16 tensor cores; at the decode step's one query row per sequence,
the bytes of k and v.  The kernel's design for both is in the source's
header: bf16 inputs go through ``mma.sync`` with f32 accumulation and
skip key tiles that the causal or window mask empties; f32 inputs take a
scalar f32 path that keeps the reference's f32 products.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 48, 64, 112, 128)
NO_WINDOW = 2 ** 31 - 1           # "no window": q_pos - k_pos is always less
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None,
                          kv_len: Optional[int] = None,
                          block_k: int = 1024) -> torch.Tensor:
    """Plain PyTorch version: the kernel's online softmax over blocks of
    ``block_k`` keys, in f32, with the reference's ``-1e30``, masked
    ``p`` and 1e-30 clamp.  Defaults: ``scale = D**-0.5``,
    ``q_offset = Sk - Sq``, ``kv_len = Sk``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    q_offset = sk - sq if q_offset is None else q_offset
    kv_len = sk if kv_len is None else kv_len
    g = h // hkv
    dev = q.device
    qf = q.to(torch.float32).reshape(b, sq, hkv, g, d)
    q_pos = torch.arange(sq, device=dev) + q_offset
    acc = torch.zeros((b, hkv, g, sq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].to(torch.float32)
        vb = v[:, k0:k0 + block_k].to(torch.float32)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)
        mask = (k_pos[None, :] < kv_len).expand(sq, -1)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash attention kernel needs q (B, Sq, H, D) "
                         f"and k, v (B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    h, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash attention kernel: {h} query heads are not "
                         f"a multiple of {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype \
            or (q.dtype == torch.float32 and k.dtype == torch.bfloat16):
        raise ValueError(f"flash attention kernel takes f32 or bf16 q with "
                         f"k and v of q's dtype or f32, got {q.dtype}, "
                         f"{k.dtype} and {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs the head dim of q, "
                         "k and v contiguous (stride 1)")


def _entry_point():
    """``repro_flash_attention`` from the built library, with its C
    signature: pointers and the stream as ``c_void_p``, strides as
    ``int64_t``, the other integers as ``int`` and the scale as
    ``float``."""
    fn = build.load("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 9 + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           q_offset: Optional[int] = None,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (no synchronise).
    Same arguments and defaults as ``flash_attention_plain``; q, k and v
    are read through their strides (the head dim must be contiguous)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    q_offset = sk - sq if q_offset is None else int(q_offset)
    kv_len = sk if kv_len is None else int(kv_len)
    window = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _entry_point()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window, scale, q_offset, kv_len,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
