"""Field-input builder: positional code + viewdir concat in one pass.

Replaces the TPU kernel `pixelnerf_tpu/ops/posenc_pallas.py:posenc_concat`
(`_kernel`, one Pallas pass per 2048-row tile) by the CUDA C++ kernel of
`csrc/posenc.cu`, whose header note gives the bound on the H100 (the bytes,
24 B read and 84 B written a row at F = 6, or the precise sines' issue,
whichever is larger) and the design. It emits

    x = [base | sin(tile(base, 2F) * ff + pp) | viewdirs]   (M, 3 + 6F + 3)

in the MLP's operand dtype (bf16, or float32), column order as in the JAX
kernel, each product and sum rounded on its own and the sine the precise
one, as the plain version's elementwise ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pixelnerf_tpu_torch.models.code import freq_phase
from pixelnerf_tpu_torch.ops.cuda_build import SMEM_LIMIT, load_library
from pixelnerf_tpu_torch.ops.scatter_plan import aligned

__all__ = ["posenc_concat", "posenc_concat_plain", "posenc_supported"]


def posenc_supported(d_in: int, num_freqs: int, include_input: bool) -> bool:
    """Exactly the layout this kernel emits: [x, code(x), viewdirs]."""
    return include_input and d_in == 3 and num_freqs >= 1


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
def _library() -> ctypes.CDLL:
    """The built `csrc/posenc.cu`, its C signatures bound once."""
    lib = load_library("posenc")
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    lib.pnt_posenc_smem_bytes.restype = ctypes.c_size_t
    lib.pnt_posenc_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.pnt_posenc.restype = ctypes.c_int
    lib.pnt_posenc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_float
    ] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch(base, viewdirs, num_freqs, freq_factor, out_dtype):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"posenc_concat writes bfloat16 or float32, not {out_dtype}")
    freqs, phases = freq_phase(num_freqs, freq_factor)
    lib = _library()
    out_f32 = int(out_dtype == torch.float32)
    if lib.pnt_posenc_smem_bytes(num_freqs, out_f32) > SMEM_LIMIT:
        raise ValueError(f"{num_freqs} frequencies do not fit a block's shared memory")
    m = base.shape[0]
    out = torch.empty((m, 6 * num_freqs + 6), dtype=out_dtype, device=base.device)
    if m == 0:
        return out
    base, viewdirs = aligned(base, 16), aligned(viewdirs, 16)
    err = lib.pnt_posenc(
        base.data_ptr(), viewdirs.data_ptr(), out.data_ptr(), m, num_freqs,
        float(freqs[0]), float(phases[1]), out_f32,
        torch.cuda.current_stream(base.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"posenc_concat launch failed: {lib.pnt_error_string(err).decode()}")
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

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/posenc.cu` (and count the launch in `posenc_concat.launches`).
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
