"""Field-input builder: positional code + viewdir concat in one pass.

Replaces the TPU kernel `pixelnerf_tpu/ops/posenc_pallas.py:posenc_concat`
(`_kernel`, one Pallas pass per 2048-row tile). It emits

    x = [base | sin(tile(base, 2F) * ff + pp) | viewdirs]   (M, 3 + 6F + 3)

in the MLP's operand dtype, column order as in the JAX kernel.

Bound on the H100: memory. Each row reads 24 B and writes 84 B (bf16,
F=6); the 36 sines per row are far below the card's arithmetic rate, so
the least time is bytes / 3.35 TB/s.

Design: one Triton program per 128-row block lays the 42 output columns
of each row on one 64-wide column axis; every column picks its source
(base, code or viewdir) by index arithmetic, so the row is written once
with no intermediate in device memory, exactly the fusion the TPU kernel
did in VMEM.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pixelnerf_tpu_torch.models.code import freq_phase

__all__ = ["posenc_concat", "posenc_concat_plain", "posenc_supported"]

_BLOCK_M = 128


def posenc_supported(d_in: int, num_freqs: int, include_input: bool) -> bool:
    """Exactly the layout this kernel emits: [x, code(x), viewdirs]."""
    return include_input and d_in == 3 and num_freqs >= 1


def _flat_freq_phase(num_freqs: int, freq_factor: float):
    """(6F,) float32 frequency and phase for code column f*3 + d."""
    freqs, phases = freq_phase(num_freqs, freq_factor)
    return np.repeat(freqs, 3), np.repeat(phases, 3)


def posenc_concat_plain(
    base: torch.Tensor, viewdirs: torch.Tensor, num_freqs: int,
    freq_factor: float, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The plain version: PositionalEncoding then concat, in float32."""
    freqs, phases = freq_phase(num_freqs, freq_factor)
    f = torch.from_numpy(freqs).to(base.device)[:, None]
    p = torch.from_numpy(phases).to(base.device)[:, None]
    base = base.float()
    code = torch.sin(base[:, None, :] * f + p).reshape(base.shape[0], -1)
    return torch.cat([base, code, viewdirs.float()], dim=-1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def posenc_kernel(
        base_ptr, vd_ptr, ff_ptr, pp_ptr, out_ptr, M,
        NCODE: tl.constexpr, D_OUT: tl.constexpr,
        BLOCK_M: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        r2 = rows[:, None].to(tl.int64)
        c2 = tl.arange(0, BLOCK_D)[None, :]
        inside = (rows[:, None] < M) & (c2 < D_OUT)
        is_base = c2 < 3
        is_code = (c2 >= 3) & (c2 < 3 + NCODE)
        is_vd = (c2 >= 3 + NCODE) & (c2 < D_OUT)
        k = tl.where(is_code, c2 - 3, 0)  # code column f*3 + d
        d = tl.where(is_base, c2, tl.where(is_code, k % 3, c2 - 3 - NCODE))
        b = tl.load(base_ptr + r2 * 3 + d, mask=inside & (is_base | is_code), other=0.0)
        v = tl.load(vd_ptr + r2 * 3 + d, mask=inside & is_vd, other=0.0)
        f = tl.load(ff_ptr + k, mask=is_code, other=0.0)
        p = tl.load(pp_ptr + k, mask=is_code, other=0.0)
        val = tl.where(is_base, b, tl.where(is_code, tl.sin(b * f + p), v))
        tl.store(
            out_ptr + r2 * D_OUT + c2, val.to(out_ptr.dtype.element_ty), mask=inside
        )

    return posenc_kernel


def _launch(base, viewdirs, num_freqs, freq_factor, out_dtype):
    ff, pp = _flat_freq_phase(num_freqs, freq_factor)
    ff = torch.from_numpy(ff).to(base.device)
    pp = torch.from_numpy(pp).to(base.device)
    m = base.shape[0]
    ncode = 6 * num_freqs
    d_out = 3 + ncode + 3
    out = torch.empty((m, d_out), dtype=out_dtype, device=base.device)
    block_d = 1 << (d_out - 1).bit_length()
    grid = ((m + _BLOCK_M - 1) // _BLOCK_M,)
    _triton_kernel()[grid](
        base, viewdirs, ff, pp, out, m,
        NCODE=ncode, D_OUT=d_out, BLOCK_M=_BLOCK_M, BLOCK_D=block_d,
        num_warps=4,
    )
    posenc_concat.launches += 1
    return out


def posenc_concat(
    base: torch.Tensor,
    viewdirs: torch.Tensor,
    num_freqs: int,
    freq_factor: float,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """[base | sin-code(base) | viewdirs] in `out_dtype`, one fused pass.

    :param base (M, 3) float32 camera-space points
    :param viewdirs (M, 3) float32 rotated view directions
    :return (M, 3 + 6*num_freqs + 3)

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (and count the launch in `posenc_concat.launches`).
    """
    if base.ndim != 2 or base.shape[1] != 3 or viewdirs.shape != base.shape:
        raise ValueError(f"need (M, 3) base and viewdirs, got {base.shape}, {viewdirs.shape}")
    if base.device.type == "cpu":
        return posenc_concat_plain(base, viewdirs, num_freqs, freq_factor, out_dtype)
    if base.device.type != "cuda" or viewdirs.device != base.device:
        raise ValueError(f"posenc_concat runs on CUDA or CPU tensors, got {base.device}")
    if base.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise TypeError("posenc_concat takes float32 base and viewdirs")
    return _launch(
        base.contiguous(), viewdirs.contiguous(), num_freqs, freq_factor, out_dtype
    )


posenc_concat.launches = 0
