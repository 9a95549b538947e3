"""Mamba2 SSD chunked scan: the recurrence

    h_t = exp(a_t)·h_{t-1} + x_t ⊗ B_t,   y_t = C_t · h_t,   h_0 = 0

computed a chunk of ``l`` steps at a time. Per chunk, with cs the
cumulative sum of a inside the chunk and S the carried (P × N) state:

    y = (C·Bᵀ ∘ L)·x + exp(cs)·(C·Sᵀ),  L[i,j] = exp(cs_i − cs_j), i ≥ j
    S ← exp(cs_last)·S + Σ_j exp(cs_last − cs_j) x_j ⊗ B_j

xdt is (B, H, S, P), a (B, H, S) (the per-step log-decay dt·A), Bm and
Cm (B, S, N), shared across heads. xdt, Bm and Cm are all float32 or all
bfloat16 (widened to float32, as the Pallas kernel does); a is float32.
y is (B, H, S, P) float32. The chunk is ``min(chunk, S)`` and must
divide S: a ragged S raises, as the reference asserts.

On a CUDA tensor :func:`ssd_scan` runs the hand-written chunk-parallel
scan in ``csrc/ssd_scan.cu`` (it replaces the Pallas TPU kernel of
:mod:`repro.kernels.ssd_scan`): four CUDA kernels per call (C·Bᵀ per
batch and chunk, the chunk states, the sequential pass over them, the
outputs), their products on the tensor cores by 3xTF32; the source
says what bounds it and how. The wrapper allocates their scratch.
On a CPU tensor it runs :func:`ssd_scan_plain`, a torch port of the
reference's ``ssm.ssd_chunked`` in the kernel's layout, with the
inter-chunk recurrence written as a decay matrix over chunks (no
sequential loop), which the card also uses as the kernel's yardstick.

Gradients: :func:`ssd_scan` is a ``torch.autograd.Function`` on both
devices. Its forward is the kernels (card) or the plain version (CPU);
it saves only its inputs, and its backward runs :func:`ssd_scan_plain`
again on them under autograd, so the gradients of xdt, a, Bm and Cm are
autograd's gradients of the plain version, each of its input's type (a
stays float32). The reference trains through its jnp ``ssd_chunked``,
never through its Pallas kernel, so there is no backward kernel to
port; this recompute stands in for one.

``launches`` counts calls that launched the kernels (one per call, for
its four CUDA kernels; never plain-version calls), so a run can show
that it went through them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import PLAIN_DEVICES, _build
from repro_torch.kernels._grad import recompute_grads

launches = 0

# the types xdt, Bm and Cm may have, and the code the C entry point reads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def _segsum(x):
    """x (..., T) -> (..., T, T): [i, j] = Σ_{k=j+1..i} x_k for i ≥ j,
    −inf above the diagonal. Each entry sums its own segment (no
    difference of long prefix sums), so it stays exact to rounding."""
    T = x.shape[-1]
    xr = x[..., None].expand(*x.shape, T)          # [..., i, j] = x_i
    strict = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                        diagonal=-1)
    seg = torch.cumsum(xr.masked_fill(~strict, 0.0), dim=-2)
    lower = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~lower, float("-inf"))


def ssd_scan_plain(xdt, a, Bm, Cm, *, chunk: int = 128):
    """Plain PyTorch version (the reference's ``ssd_chunked`` in the
    kernel's layout). bfloat16 inputs are widened to float32 (float64
    stays float64). Returns y (B,H,S,P) in the widened type."""
    xdt, Bm, Cm = (x.float() if x.dtype == torch.bfloat16 else x
                   for x in (xdt, Bm, Cm))
    B_, H, S, P = xdt.shape
    N = Bm.shape[-1]
    chunk = _chunk(S, chunk)
    nc = S // chunk
    x = xdt.reshape(B_, H, nc, chunk, P)
    A = a.reshape(B_, H, nc, chunk)
    Bc = Bm.reshape(B_, nc, chunk, N)
    Cc = Cm.reshape(B_, nc, chunk, N)
    cs = torch.cumsum(A, dim=-1)                               # (B,H,c,l)
    Lmat = torch.exp(_segsum(A))                               # (B,H,c,l,l)
    scores = Cc @ Bc.transpose(-1, -2)                         # (B,c,l,l)
    y_diag = (scores[:, None] * Lmat) @ x                      # (B,H,c,l,P)
    decay = torch.exp(cs[..., -1:] - cs)                       # (B,H,c,l)
    states = (x * decay[..., None]).transpose(-1, -2) @ Bc[:, None]
    # state before each chunk: decay-weighted sum of earlier chunks' states
    last = F.pad(cs[..., -1], (1, 0))                          # (B,H,c+1)
    chunk_decay = torch.exp(_segsum(last))                     # (B,H,c+1,c+1)
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    prev = torch.einsum("bhzc,bhcpn->bhzpn", chunk_decay, states)[:, :, :-1]
    y_off = (Cc[:, None] @ prev.transpose(-1, -2)) * torch.exp(cs)[..., None]
    return (y_diag + y_off).reshape(B_, H, S, P)


def _chunk(S: int, chunk: int) -> int:
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}; the scan does not pad")
    return chunk


def _check(xdt, a, Bm, Cm):
    if a.dtype != torch.float32:
        raise TypeError(f"a must be torch.float32; got {a.dtype}")
    for name, t in (("xdt", xdt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype not in DTYPES or t.dtype != xdt.dtype:
            raise TypeError(f"xdt, Bm and Cm must all be torch.float32 or "
                            f"all torch.bfloat16; got {name} {t.dtype}, "
                            f"xdt {xdt.dtype}")
    for name, t in (("a", a), ("Bm", Bm), ("Cm", Cm)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
    if xdt.dim() != 4:
        raise ValueError(f"xdt must be (B,H,S,P); got {tuple(xdt.shape)}")
    B_, H, S, P = xdt.shape
    if tuple(a.shape) != (B_, H, S):
        raise ValueError(f"a must be {(B_, H, S)}; got {tuple(a.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B_, S) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be (B, S, N) with B={B_}, S={S}; "
                         f"got {tuple(Bm.shape)} and {tuple(Cm.shape)}")


def ssd_scan(xdt, a, Bm, Cm, *, chunk: int = 128):
    """xdt (B,H,S,P), Bm/Cm (B,S,N) float32 or bfloat16, a (B,H,S)
    float32 -> y (B,H,S,P) float32. The kernels on CUDA tensors (four
    CUDA kernels, counted as one launch), the plain version on CPU and
    meta tensors. Differentiable in all four inputs (the backward recomputes
    the plain version)."""
    _check(xdt, a, Bm, Cm)
    if xdt.shape[2] == 0:
        return torch.zeros(xdt.shape, dtype=torch.float32,
                           device=xdt.device)
    if xdt.device.type not in PLAIN_DEVICES + ("cuda",):
        raise ValueError(f"no kernel for device {xdt.device}")
    return _SSDScan.apply(xdt, a, Bm, Cm, _chunk(xdt.shape[2], chunk))


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(xdt, a, Bm, Cm, chunk):
        if xdt.device.type in PLAIN_DEVICES:
            return ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk)
        return _launch(xdt, a, Bm, Cm, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.chunk = inputs[4]

    @staticmethod
    def backward(ctx, grad_y):
        grads = recompute_grads(ssd_scan_plain, ctx.saved_tensors,
                                ctx.needs_input_grad[:4], grad_y,
                                chunk=ctx.chunk)
        return (*grads, None)


def _launch(xdt, a, Bm, Cm, l):
    """One call of the four CUDA kernels on checked inputs, S > 0, l the
    chunk."""
    global launches
    B_, H, S, P = xdt.shape
    N = Bm.shape[-1]
    for name, t in (("xdt", xdt), ("a", a), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P > 128 or N > 128 or l > 128:
        raise ValueError(f"chunk {l}, P {P}, N {N}: the kernel takes each up "
                         "to 128")
    y = torch.empty(xdt.shape, dtype=torch.float32, device=xdt.device)
    if y.numel() == 0:
        return y
    nc, lp = S // l, -(-l // 16) * 16
    f32 = dict(dtype=torch.float32, device=xdt.device)
    cb = torch.empty((B_, nc, lp, lp), **f32)          # C·Bᵀ per chunk
    states = torch.empty((B_, H, nc, P, N), **f32)     # s_c, then S_c
    decay = torch.empty((B_, H, nc), **f32)            # exp(cs_last)
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), cb.data_ptr(), states.data_ptr(),
                 decay.data_ptr(), B_, H, S, P, N, l, DTYPES[xdt.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y
