"""Core streaming-block abstraction (PyTorch port of qradiolink_tpu/core.py).

A *block* is a function on explicit state:

    state', y = block(state, x)

and a *chain* is a composition of blocks run eagerly, one IQ time-block at
a time. Because state is explicit, processing a stream in one big block or
many small blocks gives the same output, and a state tree can cross between
this package and the JAX package (`state_from_numpy`, `state_to_numpy`,
`save_state`, `load_state`): the leaves are the same arrays in the same
depth-first order.

Blocks are plain Python objects: hyperparameters (taps, rates) are built on
the host at construction and moved once to the block's device; state is a
nested tuple of tensors on that device. All blocks operate on the LAST axis
(time) and broadcast over leading axes (channels).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch

State = Any


def resolve_device(device=None) -> torch.device:
    """The device a block runs on: CUDA unless the caller names another.

    With no device given and no CUDA card present this raises instead of
    running on the CPU, so a host without a card is never mistaken for
    one with a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Block:
    """Base class for streaming DSP blocks.

    Subclasses implement:
      init_state(self) -> State           (nested tuple of tensors; may be ())
      __call__(self, state, x) -> (State, y)
    """

    def init_state(self) -> State:
        return ()

    def __call__(self, state: State, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def one_shot(self, x):
        """Run on a single block from fresh state, return output only."""
        _, y = self(self.init_state(), x)
        return y


class Stateless(Block):
    """Block with no carried state."""

    def apply(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, state: State, x):
        return state, self.apply(x)


class Fn(Stateless):
    """Wrap a plain function as a stateless block."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def apply(self, x):
        return self.fn(x)


class Chain(Block):
    """Serial composition of blocks. State is a tuple of member states."""

    def __init__(self, blocks: Sequence[Block], name: str = "chain"):
        self.blocks = tuple(blocks)
        self.name = name

    def init_state(self) -> State:
        return tuple(b.init_state() for b in self.blocks)

    def __call__(self, state: State, x):
        new_states = []
        for b, s in zip(self.blocks, state):
            s, x = b(s, x)
            new_states.append(s)
        return tuple(new_states), x


class Sequencer:
    """Threads state through blocks called in a fixed order; the call order
    defines the state tuple's layout."""

    def __init__(self, state: State):
        self._iter = iter(state)
        self._new = []

    def __call__(self, block: Block, x):
        s, y = block(next(self._iter), x)
        self._new.append(s)
        return y

    def states(self) -> State:
        return tuple(self._new)


def init_states(blocks: Sequence[Block]) -> State:
    return tuple(b.init_state() for b in blocks)


def device_init_state(block: Block) -> State:
    """A block's initial state on its device: its init_state(), whose
    leaves every block of this package creates on its device already.

    The JAX package needs a function of its own here because the TPU it
    was written for cannot transfer a complex64 array from the host (such
    a transfer poisons the device stream), so it creates the state inside
    a jitted program; PyTorch on CUDA moves complex64 like any dtype."""
    return block.init_state()


class IqPair(NamedTuple):
    """Complex IQ carried as two float32 planes of one shape.

    The ABI of every kernel in this package: a kernel takes the planes as
    separate f32 pointers, so complex input is split once at the chain head
    and recombined only where a stage needs complex arithmetic."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def real(self):
        return self.re

    @property
    def imag(self):
        return self.im

    def to_complex(self) -> torch.Tensor:
        return torch.complex(self.re, self.im)

    # real-scalar scaling stays plane-wise; the tuple-repetition semantics
    # a NamedTuple would inherit are useless for a signal type
    def __mul__(self, other):
        return IqPair(self.re * other, self.im * other)

    __rmul__ = __mul__


def as_iq_pair(x) -> IqPair:
    """IqPair as is; a complex tensor split into contiguous f32 planes."""
    if isinstance(x, IqPair):
        return x
    if not torch.is_complex(x):
        raise TypeError(f"expected IqPair or a complex tensor, got {x.dtype}")
    return IqPair(x.real.float().contiguous(), x.imag.float().contiguous())


def iq_abs(x) -> torch.Tensor:
    """Magnitude for complex tensors or IqPair (plane-wise)."""
    if isinstance(x, IqPair):
        return torch.sqrt(x.re * x.re + x.im * x.im)
    return torch.abs(x)


def iq_take(x, idx, axis: int = -2):
    """Channel-subset selection for complex tensors and IqPair. A contiguous
    ascending index range becomes a slice (a view); anything else gathers."""
    idx_np = np.asarray(idx)

    def take(a):
        ax = axis % a.ndim
        if idx_np.ndim == 1 and idx_np.size > 0 and np.array_equal(
                idx_np, np.arange(idx_np[0], idx_np[0] + idx_np.size)):
            return a.narrow(ax, int(idx_np[0]), int(idx_np.size))
        return a.index_select(ax, torch.as_tensor(idx_np, device=a.device))

    if isinstance(x, IqPair):
        return IqPair(take(x.re), take(x.im))
    return take(x)


def put_iq_pair(x, device=None) -> IqPair:
    """Complex IQ to the device as an IqPair of two f32 planes: an IqPair
    as is, a (re, im) tuple of arrays, or a complex array (numpy or a
    tensor). device: None means CUDA (resolve_device)."""
    if isinstance(x, IqPair):
        return x
    dev = resolve_device(device)
    if isinstance(x, tuple) and len(x) == 2:
        re, im = x
    else:
        a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        re, im = a.real, a.imag
    return IqPair(*(torch.from_numpy(np.ascontiguousarray(
        p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p,
        dtype=np.float32)).to(dev) for p in (re, im)))


def put_iq(x, device=None) -> torch.Tensor:
    """An IQ array (numpy or a tensor) to the device: complex64 for complex
    input, as is otherwise. device: None means CUDA (resolve_device)."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return (x.to(torch.complex64) if torch.is_complex(x) else x).to(dev)
    a = np.asarray(x)
    if np.iscomplexobj(a):
        a = a.astype(np.complex64)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def get_iq(x) -> np.ndarray:
    """IQ to the host as numpy: complex64 for an IqPair or a complex
    tensor; a numpy array passes through."""
    if isinstance(x, IqPair):
        return (x.re.detach().cpu().numpy()
                + 1j * x.im.detach().cpu().numpy()).astype(np.complex64)
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.astype(np.complex64) if np.iscomplexobj(a) else a
    return np.asarray(x)


def run_stream(block: Block, chunks: Iterable, state: State = None):
    """Host-side streaming loop: feed successive chunks through `block`,
    yielding the output of each."""
    if state is None:
        state = block.init_state()
    for chunk in chunks:
        state, y = block(state, chunk)
        yield y


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure: nested dicts, tuples,
    lists and IqPairs (rebuilt as IqPairs) of tensors; None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, IqPair):
        return IqPair(*(tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def scan_stream(block: Block, x_blocks, state: State = None):
    """Run `block` over a pre-split stream, one block after another on the
    block's device (the JAX package's lax.scan).

    x_blocks: a tensor (N, ...block shape...), or an IqPair of such
    planes. Returns (final_state, y_blocks), every leaf of the output
    stacked to (N, ...)."""
    if state is None:
        state = block.init_state()
    ys = []
    for i in range(x_blocks.shape[0]):
        state, y = block(state, tree_map(lambda a: a[i], x_blocks))
        ys.append(y)
    return state, tree_map(lambda *leaves: torch.stack(leaves), *ys)


def concat_stream_out(y_blocks: torch.Tensor) -> torch.Tensor:
    """Collapse scan_stream block outputs (N, ..., T) back to (..., N*T)."""
    y = torch.movedim(y_blocks, 0, -2)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])


# -- state trees --------------------------------------------------------------
# A state is a nested tuple (or list) of tensors; None and () hold no leaf.
# Leaves are visited depth-first, left to right: the order jax.tree_util
# gives the JAX package's states, so leaf i is the same array on both sides.

def _flatten(tree, out: list):
    if tree is None:
        return out
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _flatten(t, out)
        return out
    out.append(tree)
    return out


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return tuple(_rebuild(t, leaves) for t in like)
    return next(leaves)


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(t) for t in tree) + ")"
    return "*"


def state_to_numpy(tree):
    """A state tree with numpy leaves, in the same nested-tuple layout."""
    return _rebuild(tree, iter([leaf.detach().cpu().numpy()
                                for leaf in _flatten(tree, [])]))


def state_from_numpy(tree, device) -> State:
    """Tensors on `device` from a state tree with array leaves (numpy, or
    anything np.asarray takes, such as the JAX package's state mapped
    through np.asarray). Dtypes and shapes are kept."""
    device = torch.device(device)
    leaves = [torch.from_numpy(np.array(leaf, copy=True)).to(device)
              for leaf in _flatten(tree, [])]
    return _rebuild(tree, iter(leaves))


def save_state(path, state: State) -> None:
    """Snapshot a streaming state tree to disk (.npz), in the JAX package's
    format: leaf i as `l{i}` (a complex leaf as `l{i}_re` / `l{i}_im` f32
    planes), the leaf count as `_n`, and a structure string as `_treedef`.
    A snapshot written by either package loads into the other."""
    arrays = {}
    leaves = _flatten(state, [])
    for i, leaf in enumerate(leaves):
        a = leaf.detach().cpu().numpy()
        if np.iscomplexobj(a):
            arrays[f"l{i}_re"] = np.ascontiguousarray(a.real)
            arrays[f"l{i}_im"] = np.ascontiguousarray(a.imag)
        else:
            arrays[f"l{i}"] = a
    arrays["_treedef"] = np.frombuffer(_structure(state).encode(),
                                       dtype=np.uint8)
    arrays["_n"] = np.asarray(len(leaves))
    np.savez(path, **arrays)


def load_state(path, like: State) -> State:
    """Restore a snapshot written by save_state (of either package). `like`
    gives the tree structure and each leaf's device (e.g. the chain's
    init_state()); `_treedef` is not read. Leaf shapes must match, up to a
    reshape of the same number of elements."""
    leaves_like = _flatten(like, [])
    with np.load(path) as data:
        n = int(data["_n"])
        if n != len(leaves_like):
            raise ValueError(
                f"snapshot has {n} leaves, structure expects "
                f"{len(leaves_like)}")
        out = []
        for i, ref in enumerate(leaves_like):
            if f"l{i}_re" in data:
                a = (data[f"l{i}_re"].astype(np.float32)
                     + 1j * data[f"l{i}_im"].astype(np.float32)
                     ).astype(np.complex64)
            else:
                a = data[f"l{i}"]
            leaf = torch.from_numpy(np.array(a, copy=True)).to(ref.device)
            if tuple(leaf.shape) != tuple(ref.shape):
                if leaf.numel() != ref.numel():
                    raise ValueError(
                        f"leaf {i}: snapshot shape {tuple(leaf.shape)} != "
                        f"expected {tuple(ref.shape)}")
                leaf = leaf.reshape(ref.shape)  # 0-d/1-d scalar round trip
            out.append(leaf)
    return _rebuild(like, iter(out))
