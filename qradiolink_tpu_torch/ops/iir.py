"""First-order IIR recurrences (port of qradiolink_tpu/ops/iir.py).

Single-pole IIRs appear throughout the reference (de-emphasis, DC blocker,
squelch power average). The recurrence

    y[n] = a[n] * y[n-1] + u[n]

is solved as a prefix scan over pairs (A, B) combined as
(A1*A2, B1*A2 + B2), in O(log T) tensor operations, with no loop over
samples. The scan is the odd/even recursion of jax.lax.associative_scan
(jax/_src/lax/control_flow/loops.py), written out in PyTorch, so the
products and sums are formed in the reference's order and the results
agree with it to f32 rounding. A closed form with a**-n would overflow.
"""

from __future__ import annotations

import torch

from qradiolink_tpu_torch.core import Block, resolve_device


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along the last axis; len(even) is len(odd) or
    one more."""
    n_o = odd.shape[-1]
    pairs = torch.stack([even[..., :n_o], odd], dim=-1)
    out = pairs.reshape(odd.shape[:-1] + (2 * n_o,))
    if even.shape[-1] > n_o:
        out = torch.cat([out, even[..., n_o:]], dim=-1)
    return out


def _scan(elems):
    """Inclusive prefix scan of (A, B) pairs under _combine along the last
    axis, in jax.lax.associative_scan's order of operations."""
    a, b = elems
    n = a.shape[-1]
    if n < 2:
        return elems
    reduced = _combine((a[..., 0:n - 1:2], b[..., 0:n - 1:2]),
                       (a[..., 1::2], b[..., 1::2]))
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _combine((odd[0][..., :-1], odd[1][..., :-1]),
                        (a[..., 2::2], b[..., 2::2]))
    else:
        even = _combine(odd, (a[..., 2::2], b[..., 2::2]))
    even = (torch.cat([a[..., :1], even[0]], dim=-1),
            torch.cat([b[..., :1], even[1]], dim=-1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def linear_recurrence(a, u: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Solve y[n] = a[n]*y[n-1] + u[n] along the last axis, y[-1] = y0.
    `a` is a scalar or a tensor that broadcasts to u."""
    a = torch.broadcast_to(torch.as_tensor(a, dtype=u.dtype, device=u.device),
                           u.shape)
    A, B = _scan((a, u))
    return A * y0.unsqueeze(-1) + B


class FirstOrderIir(Block):
    """y[n] = a1*y[n-1] + b0*x[n] + b1*x[n-1]; state = (x[-1], y[-1])."""

    def __init__(self, b0: float, b1: float = 0.0, a1: float = 0.0,
                 lead_shape: tuple = (), device=None):
        self.b0 = float(b0)
        self.b1 = float(b1)
        self.a1 = float(a1)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        z = torch.zeros(self.lead_shape, dtype=torch.float32,
                        device=self.device)
        return (z, z.clone())

    def __call__(self, state, x):
        x_prev, y_prev = state
        x_shift = torch.cat([x_prev.unsqueeze(-1), x[..., :-1]], dim=-1)
        u = self.b0 * x + self.b1 * x_shift
        y = linear_recurrence(self.a1, u, y_prev)
        return (x[..., -1], y[..., -1]), y


class SinglePoleIir(Block):
    """y[n] = (1-alpha)*y[n-1] + alpha*x[n] (gr::filter::single_pole_iir)."""

    def __init__(self, alpha: float, lead_shape: tuple = (), device=None):
        self.alpha = float(alpha)
        self.lead_shape = tuple(lead_shape)
        self.device = resolve_device(device)

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        y = linear_recurrence(1.0 - self.alpha, self.alpha * x, state)
        return y[..., -1], y
