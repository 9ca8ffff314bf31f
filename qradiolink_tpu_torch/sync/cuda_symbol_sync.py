"""The M&M symbol sync's loop: wrapper, plain version and the CUDA kernel
`symbol_sync_mm_f32` (csrc/symbol_sync.cu).

Not the port of a Pallas kernel: the JAX package runs the loop as a
`lax.scan` over output symbols (qradiolink_tpu/sync/symbol_sync.py:
131-152). Per row, over xc = [tail | x] (the carried tail, then the block,
real input taken as complex with a zero imaginary part), from (pos, omega,
y_prev, d_prev), for each of the n_out symbols, each operation rounded on
its own:

    p     = clip(pos, 2, total - 3);  b = floor(p);  mu = p - b
    c     = the cubic-Lagrange coefficients of mu (_cubic_coeffs' order,
            its quotients by constants as XLA folds them: products with the
            f32 reciprocals)
    y     = ((w0 c0 + w1 c1) + w2 c2) + w3 c3,  w_k = xc[b - 1 + k]
    d     = decision(y)                   (MODE below)
    err   = Re(d_prev conj(y) - d conj(y_prev))   (MODE_CONJ)
          = Re(d_prev y - d y_prev)                (MODE_LEVELS, MODE_SIGN)
    err   = clip(err * (1 / ted_norm), -1, 1)
    omega = clip(omega + beta err, omega_min, omega_max)
    pos   = (pos + omega) + alpha err

The products with d are written out as XLA's complex product computes
them. Decisions: MODE_CONJ (complex input, no levels) and MODE_SIGN (real
input, no levels) take (sign(yr), sign(yi)); MODE_LEVELS the nearest of
the levels to y (the complex |y - l|, the first on ties), imaginary part
0. For real input yi is interpolated from the tail's imaginary parts and
zeros, as in JAX. The carried tail and the shifted position are computed
around the loop, as the JAX block does (symbol_sync.py:157-159).

On a CPU tensor the wrapper takes the plain version (a loop over the
symbols, about 45 PyTorch ops each); on a CUDA tensor it launches the
kernel, one lane a row, or raises. The two are equal bit for bit. The
kernel reads each row's samples from a ring in shared memory that a second
warp fills a chunk of symbols ahead of the position; `ring_plan` sizes the ring and
the chunk from the loop's parameters, and the wrapper raises, on either
device, where the largest ring cannot serve them.

Real input with levels (M17, DMR, the 2FSK/4FSK/GMSK chains) runs the
kernel's real-levels path where a block's tails have an imaginary plane of
+0 words, as SymbolSync's state always has: yi is then +0 for every
symbol (csrc/symbol_sync.cu, `update`), so the kernel neither copies nor
interpolates that plane, and each level's distance is |yr - l|, which
equals hypot(yr - l, +0) bit for bit (a card test checks every f32); the
levels are reduced by a (distance, level) tree to the first minimum.
Other tails run the interpolated plane and a hypotf a level, the code
every row ran before, which `symbol_sync_levels_v0` launches on
any real input for timing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qradiolink_tpu_torch.utils import kernels
from qradiolink_tpu_torch.utils.profiling import kernel_paths

OP = "symbol_sync_mm_f32"
# the levels mode on real input as every row ran it before the real-levels
# path (the kernel's mode 3): on no route, launched for timing in turns
V0_OP = "symbol_sync_levels_v0"
MODE_CONJ, MODE_LEVELS, MODE_SIGN = 0, 1, 2
_MODE_LEVELS_V0 = 3
MAX_LEVELS = 8
# the kernel's ring: at most RING_MAX samples a lane (32 lanes x (512 + 2)
# x 8 bytes of shared memory), chunks of CHUNKS symbols, the largest that
# fits first; a 16-byte granule holds 2 complex or 4 real samples
RING_MAX = 512
RING_MIN = 16
CHUNKS = (16, 8, 4, 2, 1)


def granule(complex_in: bool) -> int:
    return 2 if complex_in else 4


def ring_plan(sps: float, alpha: float, omega_lim: float, total: int,
              complex_in: bool) -> tuple[int, int, float]:
    """(S, R, reach) of symbol_sync_mm_f32 for a block of `total` samples of
    [tail | x]: chunks of S symbols, a ring of R samples a lane, and the
    reach that a lane's fill covers past its position at a chunk's start:
    that chunk and the next, 2S - 1 symbols of the largest advance a symbol
    (omega at its limit, |e| = 1, and the two roundings of the position),
    plus one sample. The ring must hold that reach, the granule the fill
    rounds up to and the interpolator's 4 taps behind the position: R >=
    reach + G + 6. Raises ValueError where no chunk fits RING_MAX samples,
    or where a symbol's advance can be 0 or negative (the fill assumes the
    position moves forward)."""
    f32 = np.float32
    omax = float(f32(sps + omega_lim))
    omin = float(f32(sps - omega_lim))
    a = abs(float(f32(alpha)))
    # two roundings a symbol of a position below 2 (total + 512)
    eps = 2.0 ** -22 * (total + 512)
    adv_max, adv_min = omax + a + eps, omin - a - eps
    if not adv_min > 0:
        raise ValueError(f"{OP}: a symbol's advance can reach {adv_min:.3g} "
                         f"samples (sps {sps}, gain_mu {alpha}, omega_limit "
                         f"{omega_lim}); the kernel's ring needs it above 0")
    G = granule(complex_in)
    for S in CHUNKS:
        reach = (2 * S - 1) * adv_max + 1.0
        R = RING_MIN
        while R < reach + G + 6:
            R *= 2
        if R <= RING_MAX:
            # the f32 the kernel adds, rounded up
            return S, R, float(np.nextafter(f32(reach), f32(np.inf)))
    raise ValueError(f"{OP}: a symbol can advance {adv_max:.3g} samples (sps "
                     f"{sps}, gain_mu {alpha}, omega_limit {omega_lim}); the "
                     f"kernel's ring of {RING_MAX} samples cannot hold one")


def mode_of(complex_in: bool, levels) -> int:
    """The decision variant the JAX block takes for this input."""
    if levels is not None:
        return MODE_LEVELS
    return MODE_CONJ if complex_in else MODE_SIGN


def recip(v: float) -> float:
    """1 / v rounded to f32, as XLA folds a quotient by a constant."""
    return float(np.float32(1.0) / np.float32(v))


INV6 = recip(6.0)


def cubic_coeffs(mu):
    """4-point cubic Lagrange coefficients for the points [-1, 0, 1, 2], in
    the JAX package's order of operations; XLA computes its quotients by 6
    and 2 as products with the f32 reciprocals, and so does this."""
    c_m1 = -mu * (mu - 1.0) * (mu - 2.0) * INV6
    c_0 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) * 0.5
    c_1 = -(mu + 1.0) * mu * (mu - 2.0) * 0.5
    c_2 = (mu + 1.0) * mu * (mu - 1.0) * INV6
    return c_m1, c_0, c_1, c_2


def _interp(w, c):
    """((w0 c0 + w1 c1) + w2 c2) + w3 c3 over the last axis of w."""
    y = w[..., 0] * c[0]
    for j in range(1, 4):
        y = y + w[..., j] * c[j]
    return y


def symbol_sync_plain(xr, xi, pos, omega, y_prev, d_prev, n_out: int,
                      mode: int, levels, sps: float, alpha: float,
                      beta: float, omega_lim: float, ted_norm: float):
    """Plain PyTorch version over the planes xr, xi (rows, total) f32 of
    xc = [tail | x]; y_prev, d_prev (rows,) complex64. Returns (yr, yi
    (rows, n_out), pos, omega, y_prev, d_prev), pos not yet shifted."""
    dev = xr.device
    total = xr.shape[-1]
    max_pos = float(total - 3)
    omin, omax = sps - omega_lim, sps + omega_lim
    inv_norm = recip(ted_norm)
    ypr, ypi = y_prev.real.clone(), y_prev.imag.clone()
    dpr, dpi = d_prev.real.clone(), d_prev.imag.clone()
    out_r = torch.empty(xr.shape[:-1] + (n_out,), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty_like(out_r)
    k = torch.arange(-1, 3, device=dev)
    for m in range(n_out):
        p = torch.clamp(pos, 2.0, max_pos)
        b = torch.floor(p)
        c = cubic_coeffs(p - b)
        idx = b.long()[..., None] + k
        yr = _interp(torch.gather(xr, -1, idx), c)
        yi = _interp(torch.gather(xi, -1, idx), c)
        if mode == MODE_LEVELS:
            dist = torch.abs(torch.complex(yr[..., None] - levels,
                                           yi[..., None].expand(
                                               yr.shape + levels.shape)))
            dr = levels[torch.argmin(dist, dim=-1)]
            di = torch.zeros_like(dr)
        else:
            dr, di = torch.sign(yr), torch.sign(yi)
        if mode == MODE_CONJ:
            err = (dpr * yr + dpi * yi) - (dr * ypr + di * ypi)
        else:
            err = (dpr * yr - dpi * yi) - (dr * ypr - di * ypi)
        err = torch.clamp(err * inv_norm, -1.0, 1.0)
        omega = torch.clamp(omega + beta * err, omin, omax)
        pos = (pos + omega) + alpha * err
        out_r[..., m] = yr
        out_i[..., m] = yi
        ypr, ypi, dpr, dpi = yr, yi, dr, di
    return (out_r, out_i, pos, omega, torch.complex(ypr, ypi),
            torch.complex(dpr, dpi))


def shape_key(rows: int, T: int, n_out: int, mode: int) -> str:
    """A call's key in the launch report: the mode, rows x samples ->
    symbols."""
    name = {MODE_CONJ: "conj", MODE_LEVELS: "levels", MODE_SIGN: "sign"}
    return f"{name[mode]} {rows}x{T}->{n_out}"


def _lib():
    lib = kernels.load("symbol_sync")
    if not getattr(lib, "_qrl_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.symbol_sync_mm_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, p, i, f, f,
                                           f, f, f, f, i, i, f, p]
        lib.symbol_sync_mm_f32.restype = ctypes.c_int
        lib.symbol_sync_error_string.argtypes = [i]
        lib.symbol_sync_error_string.restype = ctypes.c_char_p
        lib.symbol_sync_fabs_f32.argtypes = [p, p, ctypes.c_longlong, p]
        lib.symbol_sync_fabs_f32.restype = ctypes.c_int
        lib._qrl_bound = True
    return lib


def _check(tail, x, pos, omega, y_prev, d_prev):
    rows = tail.shape[0]
    if tail.dtype != torch.complex64 or tail.ndim != 2 or x.ndim != 2 \
            or x.shape[0] != rows \
            or x.dtype not in (torch.complex64, torch.float32) \
            or tuple(pos.shape) != (rows,) or tuple(omega.shape) != (rows,) \
            or tuple(y_prev.shape) != (rows,) \
            or tuple(d_prev.shape) != (rows,) \
            or pos.dtype != torch.float32 or omega.dtype != torch.float32 \
            or y_prev.dtype != torch.complex64 \
            or d_prev.dtype != torch.complex64 \
            or len({t.device for t in (tail, x, pos, omega, y_prev,
                                       d_prev)}) != 1:
        raise ValueError("symbol_sync: tail (rows, L) complex64, x (rows, T) "
                         "complex64 or f32, pos/omega (rows,) f32, y_prev/"
                         "d_prev (rows,) complex64, all on one device")


def symbol_sync(tail, x, pos, omega, y_prev, d_prev, n_out: int, mode: int,
                levels, sps: float, alpha: float, beta: float,
                omega_lim: float, ted_norm: float):
    """The loop over tail (rows, L) complex64 and x (rows, T) complex64 or
    f32, from pos, omega (rows,) f32 and y_prev, d_prev (rows,) complex64:
    (y (rows, n_out) complex64, pos (not shifted), omega, y_prev, d_prev).
    levels: f32 tensor of the decision levels (MODE_LEVELS) or None."""
    _check(tail, x, pos, omega, y_prev, d_prev)
    complex_in = torch.is_complex(x)
    if mode != mode_of(complex_in, levels):
        raise ValueError(f"mode {mode} does not fit this input")
    dev = x.device
    L, T = tail.shape[-1], x.shape[-1]
    # raises, on either device, where no ring can serve the loop
    ring_plan(sps, alpha, omega_lim, L + T, complex_in)
    key = shape_key(tail.shape[0], T, n_out, mode)
    if dev.type == "cpu":
        kernel_paths.record(OP, False, key)
        xc = torch.cat([tail, x.to(torch.complex64)], dim=-1)
        yr, yi, pos, omega, y_prev, d_prev = symbol_sync_plain(
            xc.real.contiguous(), xc.imag.contiguous(), pos, omega, y_prev,
            d_prev, n_out, mode, levels, sps, alpha, beta, omega_lim,
            ted_norm)
        return torch.complex(yr, yi), pos, omega, y_prev, d_prev
    if dev.type != "cuda":
        raise ValueError(f"no {OP} kernel for device {dev}")
    return _launch(OP, mode, tail, x, pos, omega, y_prev, d_prev, n_out,
                   levels, sps, alpha, beta, omega_lim, ted_norm)


def symbol_sync_levels_v0(tail, x, pos, omega, y_prev, d_prev, n_out: int,
                          levels, sps: float, alpha: float, beta: float,
                          omega_lim: float, ted_norm: float):
    """symbol_sync's levels mode on real CUDA input as every row ran it
    before the real-levels path (the imaginary plane copied and
    interpolated, a hypotf a level), on no route: symbol_sync's result, for
    timing in turns. Raises on other input."""
    _check(tail, x, pos, omega, y_prev, d_prev)
    if torch.is_complex(x) or levels is None or x.device.type != "cuda":
        raise ValueError(f"{V0_OP} takes real CUDA input with levels")
    ring_plan(sps, alpha, omega_lim, tail.shape[-1] + x.shape[-1], False)
    return _launch(V0_OP, _MODE_LEVELS_V0, tail, x, pos, omega, y_prev,
                   d_prev, n_out, levels, sps, alpha, beta, omega_lim,
                   ted_norm)


def _launch(op, mode, tail, x, pos, omega, y_prev, d_prev, n_out, levels,
            sps, alpha, beta, omega_lim, ted_norm):
    """One launch of the kernel in C mode `mode` on CUDA tensors; records
    it under `op`."""
    complex_in = torch.is_complex(x)
    dev = x.device
    rows = tail.shape[0]
    L, T = tail.shape[-1], x.shape[-1]
    S, R, reach = ring_plan(sps, alpha, omega_lim, L + T, complex_in)
    n_lv = 0 if levels is None else levels.numel()
    if n_lv > MAX_LEVELS:
        raise ValueError(f"{OP} takes at most {MAX_LEVELS} levels")
    if levels is not None and levels.device != dev:
        levels = levels.to(dev)
    tail, x = tail.contiguous(), x.contiguous()
    # the ring's 16-byte copies: rows of x a whole number of granules apart,
    # tail and x on 16-byte boundaries
    G = granule(complex_in)
    ld = T
    if T % G or x.data_ptr() % 16:
        ld = -(-T // G) * G
        xp = x.new_zeros((rows, ld))
        xp[:, :T] = x
        x = xp
    if tail.data_ptr() % 16:
        tail = tail.clone()
    pos, omega = pos.contiguous(), omega.contiguous()
    y_prev, d_prev = y_prev.contiguous(), d_prev.contiguous()
    y = torch.empty((rows, n_out), dtype=torch.complex64, device=dev)
    outs = [torch.empty_like(pos), torch.empty_like(omega),
            torch.empty_like(y_prev), torch.empty_like(d_prev)]
    if rows == 0:
        return (y, *outs)
    lv = levels.float().contiguous() if levels is not None else pos
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.symbol_sync_mm_f32(
            tail.data_ptr(), x.data_ptr(), pos.data_ptr(), omega.data_ptr(),
            y_prev.data_ptr(), d_prev.data_ptr(), y.data_ptr(),
            *(o.data_ptr() for o in outs), rows, L, T, ld, n_out,
            int(complex_in), mode, lv.data_ptr(), n_lv, sps - omega_lim,
            sps + omega_lim, alpha, beta, recip(ted_norm), float(L + T - 3),
            S, R, reach, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{op} launch failed: "
                           f"{lib.symbol_sync_error_string(err).decode()}")
    kernel_paths.record(op, True, shape_key(rows, T, n_out, MODE_LEVELS
                                            if mode == _MODE_LEVELS_V0
                                            else mode))
    return (y, *outs)


def level_distance(d: torch.Tensor) -> torch.Tensor:
    """fabsf(d) on the card, as the kernel's real-levels path computes a
    level's distance |yr - l|: d contiguous f32 on a CUDA device."""
    if d.dtype != torch.float32 or d.device.type != "cuda" \
            or not d.is_contiguous():
        raise ValueError("level_distance takes contiguous CUDA f32")
    out = torch.empty_like(d)
    lib = _lib()
    with torch.cuda.device(d.device):
        err = lib.symbol_sync_fabs_f32(
            d.data_ptr(), out.data_ptr(), d.numel(),
            torch.cuda.current_stream(d.device).cuda_stream)
    if err:
        raise RuntimeError(f"symbol_sync_fabs_f32 launch failed: "
                           f"{lib.symbol_sync_error_string(err).decode()}")
    return out
