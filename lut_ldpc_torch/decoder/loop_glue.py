"""The value-domain loop's glue: early-exit state, latch, initial
values.

``ArithLUTDecoder`` runs these around its CN and VN passes:

- ``loop_state`` after every CN pass: ``conv = unan_p & synd & ~done``
  (nothing converges at iteration 0), ``iters = conv ? it : iters`` and
  ``done |= conv`` in place, and, given a ``LiveCount``, the number of frames
  not done, copied to pinned host memory behind an event without waiting
  (``LiveCount.read`` waits);
- ``latch`` after it, in every iteration from 1 and after the loop:
  ``latched[:, conv] = bits_prev[:, conv]`` in place;
- ``init_values`` before it: the grouped channel values (nvar_pad, B) and
  the iteration-0 edge values (E_vn, B) from the (B, nvar) int32 or int64
  labels, phantom sockets pinned.

CUDA tensors launch the kernels of ``csrc/loop_glue.cu`` (a unit of the
kernel library, ``qc_kernels.UNITS``); CPU tensors run the plain versions
``*_ref`` beside them, which compute the same values.  A CUDA tensor never
falls back: the kernel launches or the wrapper raises.  Each launch goes
through ``qc_kernels.launch_on`` (the card of the tensors, its current
stream).  ``LAUNCHES`` counts each wrapper's launches, under the lock of
``qc_kernels``' counts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import qc_kernels as qk

__all__ = ["loop_state", "loop_state_ref", "latch", "latch_ref", "init_values",
           "init_values_ref", "init_table", "LiveCount", "LAUNCHES", "reset_launches"]

LAUNCHES = {"loop_state": 0, "latch": 0, "init_values": 0}
TAB_COLS = 5  # init table: variable, edge row of slot 0, n_pad, degree, phantom mask


def reset_launches() -> None:
    with qk._count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _lib():
    return qk._unit("loop_glue")


def _launched(err: int, name: str) -> None:
    if err == qk.NOTHING_TO_LAUNCH:
        return
    qk._raise_on(err, name)
    qk.count(LAUNCHES, name)


def _flags(name, t, n):
    qk._check(name, t, torch.bool, (n,), t.device)


# ---------------------------------------------------------------------------
# early-exit state
# ---------------------------------------------------------------------------
class LiveCount:
    """The live-frame count of one decoder's loop: on the card an int on the
    device, a pinned host int and an event, made once with the decoder's
    card current; ``read`` waits on the event (the copy queued behind the
    loop-state kernel on that card's current stream), not on the stream,
    and lets other threads run meanwhile.  The copy and the event are
    queued and read from whichever thread runs the decoder.  A plain
    version sets ``value`` instead."""

    def __init__(self, device: torch.device):
        self.device = device
        self.value = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.dev = torch.zeros(1, dtype=torch.int32, device=device)
                self.host = torch.zeros(1, dtype=torch.int32, pin_memory=True)
                self.event = torch.cuda.Event()

    def _queue(self) -> None:
        # the copy and the event take the device of `dev` and of the stream
        self.value = None
        self.host.copy_(self.dev, non_blocking=True)
        self.event.record(torch.cuda.current_stream(self.device))

    def read(self) -> int:
        """The count of the last ``loop_state`` given this object (or the
        value a plain version set)."""
        if self.value is None:
            self.event.synchronize()
            return int(self.host[0])
        return self.value


def loop_state_ref(unan_p, synd, done, iters, it: int):
    """Plain version of ``loop_state`` (in place on done and iters)."""
    conv = unan_p & synd & ~done if it >= 1 else torch.zeros_like(done)
    iters.masked_fill_(conv, it)
    done |= conv
    return conv


def loop_state(unan_p: torch.Tensor, synd: torch.Tensor, done: torch.Tensor,
               iters: torch.Tensor, it: int, live: LiveCount | None = None):
    """The early-exit state after iteration `it`'s CN pass: returns conv (B,)
    bool (unan_p & synd & ~done, all False for it < 1) and sets iters =
    conv ? it : iters and done |= conv in place; with `live`, the count of
    frames not done afterwards goes to it (on the card: to its pinned host
    int behind its event, read by ``live.read()``)."""
    B = done.shape[0]
    for name, t in (("unan_p", unan_p), ("synd", synd), ("done", done)):
        _flags(name, t, B)
    qk._check("iters", iters, torch.int32, (B,), done.device)
    if done.device.type == "cpu":
        conv = loop_state_ref(unan_p, synd, done, iters, it)
        if live is not None:
            live.value = int((~done).sum())
        return conv
    conv, lib = torch.empty_like(done), _lib()
    with qk.launch_on(done.device) as stream:
        err = lib.lut_loop_state(
            unan_p.data_ptr(), synd.data_ptr(), done.data_ptr(), iters.data_ptr(),
            conv.data_ptr(), None if live is None else live.dev.data_ptr(), int(it),
            int(it >= 1), B, stream)
    _launched(err, "loop_state")
    if live is not None:
        live._queue()
    return conv


def latch_ref(conv, bits_prev, latched) -> None:
    """Plain version of ``latch``."""
    torch.where(conv[None, :], bits_prev, latched, out=latched)


def latch(conv: torch.Tensor, bits_prev: torch.Tensor, latched: torch.Tensor) -> None:
    """latched[:, f] = bits_prev[:, f] for the frames f with conv[f], in place
    over every row: (B,) bool, (rows, B) int8, (rows, B) int8."""
    B = conv.shape[0]
    _flags("conv", conv, B)
    qk._check("bits_prev", bits_prev, torch.int8, (bits_prev.shape[0], B), conv.device)
    qk._check("latched", latched, torch.int8, bits_prev.shape, conv.device)
    if conv.device.type == "cpu":
        return latch_ref(conv, bits_prev, latched)
    lib = _lib()
    with qk.launch_on(conv.device) as stream:
        err = lib.lut_latch(conv.data_ptr(), bits_prev.data_ptr(), latched.data_ptr(),
                            bits_prev.shape[0], B, stream)
    _launched(err, "latch")


# ---------------------------------------------------------------------------
# initial values
# ---------------------------------------------------------------------------
def init_table(layout, phantom_rows, device) -> torch.Tensor:
    """(nvar_pad, TAB_COLS) int32: per grouped node row of the slot-major
    `layout` its variable (0 for padding rows, as layout.vn_nodes), the edge
    row of its slot 0, the block's n_pad (the stride between slots), its
    degree, and a mask of the slots whose edge rows are in `phantom_rows`."""
    tab = np.zeros((layout.nvar_pad, TAB_COLS), np.int64)
    tab[:, 0] = layout.vn_nodes
    for blk in layout.vn_blocks:
        rows = slice(blk.node_start, blk.node_start + blk.n_pad)
        tab[rows, 1] = blk.edge_start + np.arange(blk.n_pad)
        tab[rows, 2] = blk.n_pad
        tab[rows, 3] = blk.degree
        for e in phantom_rows:
            k, off = divmod(int(e) - blk.edge_start, blk.n_pad)
            if 0 <= k < blk.degree:
                tab[blk.node_start + off, 4] |= 1 << k
    if tab[:, 3].max(initial=0) > 32:
        raise ValueError("variable degree above 32: the phantom mask holds 32 slots")
    tab[:, 4] = tab[:, 4].astype(np.uint32).view(np.int32)
    return torch.as_tensor(tab.astype(np.int32), device=device)


def _labels(name, x, nvar):
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: dtype {x.dtype}, expected int32 or int64")
    if x.dim() != 2 or x.shape[1] != nvar or not x.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected contiguous (B, {nvar})")


def init_values_ref(cha, msg, tab, leaf_cha, leaf_msg0, pin, rows_vn: int):
    """Plain version of ``init_values``."""
    var, e0, n_pad, deg, ph = tab.long().unbind(1)
    vcha = leaf_cha[cha.T[var]]
    if msg is None:
        return vcha, None
    v0 = leaf_msg0[msg.T[var]]
    m_vn = torch.empty((rows_vn, cha.shape[0]), dtype=v0.dtype, device=v0.device)
    pin_v = torch.tensor(pin, dtype=v0.dtype, device=v0.device)
    for k in range(int(deg.max())):
        sel = deg > k
        pinned = ((ph[sel] >> k) & 1).bool()[:, None]
        m_vn[e0[sel] + k * n_pad[sel]] = torch.where(pinned, pin_v, v0[sel])
    return vcha, m_vn


def init_values(cha: torch.Tensor, msg: torch.Tensor | None, tab: torch.Tensor,
                leaf_cha: torch.Tensor, leaf_msg0: torch.Tensor, pin: float,
                rows_vn: int):
    """(B, nvar) int32 or int64 labels -> (grouped channel values (nvar_pad,
    B), iteration-0 edge values (rows_vn, B) or None where msg is None): row
    g of the first is leaf_cha at the label of g's variable (`tab`, from
    ``init_table``), every edge row of g in the second leaf_msg0 at its
    message label, or `pin` at a phantom socket.  Values in leaf_cha's dtype
    (int16 or float32)."""
    nvar, dev = cha.shape[1], cha.device
    _labels("channel labels", cha, nvar)
    if msg is not None:
        _labels("message labels", msg, nvar)
        if msg.shape != cha.shape or msg.device != dev:
            raise ValueError("message labels: another shape or device than the channel's")
    qk._check("table", tab, torch.int32, (tab.shape[0], TAB_COLS), dev)
    if leaf_cha.dtype not in (torch.int16, torch.float32) or leaf_msg0.dtype != leaf_cha.dtype:
        raise TypeError(f"leaf tables: {leaf_cha.dtype} / {leaf_msg0.dtype}")
    if dev.type == "cpu":
        return init_values_ref(cha, msg, tab, leaf_cha, leaf_msg0, pin, rows_vn)
    G, B = tab.shape[0], cha.shape[0]
    vcha = torch.empty((G, B), dtype=leaf_cha.dtype, device=dev)
    m_vn = (None if msg is None
            else torch.empty((rows_vn, B), dtype=leaf_cha.dtype, device=dev))
    lib = _lib()
    with qk.launch_on(dev) as stream:
        err = lib.lut_init_values(
            int(leaf_cha.dtype == torch.float32), int(cha.dtype == torch.int64),
            cha.data_ptr(), None if msg is None else msg.data_ptr(), tab.data_ptr(),
            leaf_cha.data_ptr(), leaf_cha.shape[0], leaf_msg0.data_ptr(),
            leaf_msg0.shape[0], vcha.data_ptr(), None if m_vn is None else m_vn.data_ptr(),
            float(pin), G, nvar, B, stream)
    _launched(err, "init_values")
    return vcha, m_vn
