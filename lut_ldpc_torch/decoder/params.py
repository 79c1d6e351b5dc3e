"""Carry-over of the numpy decoder description to device tensors.

Everything here is built once per decoder from the numpy objects
(``ArithSpec`` of ``arith``, ``GroupedLayout``/``QCPlan`` of ``fast_layout``):

- ``vn_params``: the per-iteration VN op parameters, stacked the way
  lut_ldpc_tpu/decoder/arith_decoder.py:259-344 stacks them and keyed the
  way its kernel path picks them (qc_kernels.py:229 ``kernel_op_keys``:
  symmetric ops carry magnitude thresholds/levels), flattened into one
  float32 row per iteration, plus the tree structure as small int tables
  the CUDA kernel reads;
- ``qc_tables``: the circulant row tables of both passes (per CN block-row
  and slot: source base, roll, destination base; per VN block-column: node
  base and the same per slot), and the gather indices of the plain twins;
- ``std_tables``: the same two passes for a graph without circulant
  structure (per degree class: node start, padded and real node counts,
  degree and edge start of its slot planes), the two row-gather
  permutations between the VN- and CN-grouped orders and the VN-grouped row
  of every CN-grouped edge row, through which the CN kernels fold both;
- ``arith_tensors``: the leaf value tables and the layout index maps;
- ``fast_tables``: the label-domain table-decoder tables
  (fast_decoder.py:135-243).

A codec loaded with ``LUTCodec.load`` goes through the same functions as a
freshly designed one.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from . import fast_layout, layout as tree_layout
from .arith import loo_msg_spans

__all__ = ["VNOp", "VNClass", "VNParams", "QCTables", "StdTables",
           "ArithTensors", "FastTables", "torch_dtype", "vn_params",
           "qc_tables", "std_tables", "arith_tensors", "fast_tables"]

# per-op row in VNParams.op_info
# operand start, operand count, nthr, flags, param offset, and the inclusive
# span of message-leaf positions under the op (-1, -1: channel leaf only)
OP_INFO_COLS = 7
FLAG_SYM, FLAG_TIE, FLAG_SORTED = 1, 2, 4


def torch_dtype(np_dtype) -> torch.dtype:
    dt = np.dtype(np_dtype)
    if dt == np.int16:
        return torch.int16
    if dt == np.float32:
        return torch.float32
    raise ValueError(f"message dtype {dt} not supported (int16 or float32)")


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


# ---------------------------------------------------------------------------
# VN op parameters
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VNOp:
    operands: tuple  # slots: leaves 0..num_inputs-1 (DFS), then op outputs
    nthr: int        # thresholds in the emission chain (magnitude ones if sym)
    sym: bool        # chain on |s|, sign restored
    has_tie: bool    # s == 0 emits tie_lo / tie_hi by the last operand's sign
    # thresholds ascend in every iteration: the select chain then picks
    # levels[number of thresholds reached], which a kernel may search for
    sorted_thr: bool
    fp: bool         # float_params op (center-pair repair inside an int16 spec)
    off: int         # offset of [thr, levels, tie_lo, tie_hi] in a param row
    span: tuple      # (lo, hi) message-leaf positions under the op, or (-1, -1)


@dataclass(frozen=True)
class VNClass:
    degree: int
    num_inputs: int  # d - 1 message leaves + the channel leaf (DFS-last)
    ops: tuple
    # the first op sums all message leaves of an integer spec: the JAX
    # kernels compute it as total-minus-self (same values on the integer
    # grid); the CUDA kernels and their twins evaluate every sum in full
    use_tot: bool


@dataclass
class VNParams:
    classes: tuple          # VNClass per VN layout block (= kernel class id)
    prm: torch.Tensor       # (num_iters, row) float32
    cls_deg: torch.Tensor   # (C,) int32
    cls_op0: torch.Tensor   # (C,) int32 first op of the class in op_info
    cls_nops: torch.Tensor  # (C,) int32
    op_info: torch.Tensor   # (total_ops * OP_INFO_COLS,) int32
    opnds: torch.Tensor     # (total_operands,) int32
    num_iters: int
    max_ops: int            # most ops in one class tree
    # the first kernel_classes classes are the layout's blocks, the ones a
    # kernel row can refer to; the rest are phantom true degrees
    kernel_classes: int
    # prm in host memory: the generated kernels take an iteration's row as
    # a kernel argument
    prm_host: np.ndarray
    # digest of the kernel classes' tree structure (everything the generated
    # kernel source depends on but the storage type and the row addressing):
    # vn_codegen finds the spec's library by it
    tree_key: str


def vn_params(spec, lay, device, extra_degrees=()) -> VNParams:
    """Stacked per-iteration VN parameters of `spec` for the blocks of the
    slot-major layout `lay`.  `extra_degrees`: spec degrees that no layout
    block has (the true degrees of phantom-completed nodes,
    arith_decoder.py:79-87); their classes follow the blocks' classes in
    `classes`, and no kernel row refers to them."""
    S = spec.num_iters
    if S < 1:
        raise ValueError("spec covers no VN iteration")
    try:
        spec_di = [spec.degrees.index(d) for d in
                   [blk.degree for blk in lay.vn_blocks] + list(extra_degrees)]
    except ValueError:
        raise ValueError("arith spec degrees do not match graph blocks")
    is_int = np.issubdtype(np.dtype(spec.dtype), np.integer)
    classes, cols = [], []  # cols: per-op (S, width) float32 blocks
    off = 0
    for di in spec_di:
        struct = spec.var_trees[0][di]
        ops = []
        spans = loo_msg_spans(struct)
        for oi, op in enumerate(struct.ops):
            sps = [spec.var_trees[ii][di].ops[oi] for ii in range(S)]
            sym = all(sp.sym_thr is not None for sp in sps)
            thr = np.stack([np.asarray(sp.sym_thr if sym else sp.thresholds,
                                       np.float32) for sp in sps])
            lev = np.stack([np.asarray(sp.sym_levels if sym else sp.levels,
                                       np.float32) for sp in sps])
            ties = np.array([[sp.tie_lo, sp.tie_hi] for sp in sps], np.float32)
            nthr = thr.shape[1]
            ops.append(VNOp(operands=tuple(int(x) for x in op.operands),
                            nthr=nthr, sym=sym,
                            has_tie=any(sp.has_zero for sp in sps),
                            sorted_thr=bool(np.all(np.diff(thr, axis=1) >= 0)),
                            fp=any(sp.float_params for sp in sps), off=off,
                            span=spans[oi] or (-1, -1)))
            cols.append(np.concatenate([thr, lev, ties], axis=1))
            off += 2 * nthr + 3
        d = spec.degrees[di]
        use_tot = (is_int and d >= 3
                   and struct.ops[0].operands == tuple(range(d - 1)))
        classes.append(VNClass(degree=d, num_inputs=struct.num_inputs,
                               ops=tuple(ops), use_tot=use_tot))
    prm = np.concatenate(cols, axis=1).astype(np.float32)

    op_info, opnds, op0, nops, degs = [], [], [], [], []
    for c in classes:
        if c.num_inputs != c.degree:
            raise ValueError("VN tree leaves != degree (d-1 messages + channel)")
        op0.append(len(op_info) // OP_INFO_COLS)
        nops.append(len(c.ops))
        degs.append(c.degree)
        for op in c.ops:
            flags = ((FLAG_SYM if op.sym else 0) | (FLAG_TIE if op.has_tie else 0)
                     | (FLAG_SORTED if op.sorted_thr else 0))
            op_info += [len(opnds), len(op.operands), op.nthr, flags, op.off,
                        *op.span]
            opnds += list(op.operands)
    return VNParams(
        classes=tuple(classes),
        prm=torch.as_tensor(prm, device=device).contiguous(),
        cls_deg=_i32(degs, device), cls_op0=_i32(op0, device),
        cls_nops=_i32(nops, device), op_info=_i32(op_info, device),
        opnds=_i32(opnds, device), num_iters=S,
        max_ops=max(len(c.ops) for c in classes),
        kernel_classes=len(lay.vn_blocks), prm_host=np.ascontiguousarray(prm),
        tree_key=hashlib.sha256(
            repr(classes[: len(lay.vn_blocks)]).encode()).hexdigest())


# ---------------------------------------------------------------------------
# QC circulant tables
# ---------------------------------------------------------------------------
@dataclass
class QCTables:
    Z: int
    rows_cn: int     # CN-grouped edge rows (slot-major, padded)
    rows_vn: int     # VN-grouped edge rows
    nvar_pad: int
    max_dc: int
    max_dv: int
    # kernel tables: row r, slot k.  CN: m_cn[cn_dst + z] =
    # m_vn[cn_src + (z + cn_shift) % Z]; VN: m_vn[vn_dst + z] =
    # m_cn[vn_src + (z + vn_shift) % Z], channel/bits row vn_node + z
    cn_src: torch.Tensor
    cn_shift: torch.Tensor
    cn_dst: torch.Tensor
    cn_deg: torch.Tensor
    vn_src: torch.Tensor
    vn_shift: torch.Tensor
    vn_dst: torch.Tensor
    vn_node: torch.Tensor
    vn_cls: torch.Tensor
    vn_runs: tuple   # (first row, end row, class) runs of vn_cls
    cn_runs: tuple   # (first row, end row, check degree) runs of cn_deg
    # plain-twin gathers, one entry per run of rows of one class:
    # cn_plain: (src (d, n) int64, dst (d, n) int64)
    # vn_plain: (class idx, src (d, n), dst (d, n), node (n,))
    cn_plain: list
    vn_plain: list
    # real (non-padding) rows of the standard layouts, for comparisons
    cn_real: torch.Tensor
    vn_real: torch.Tensor
    node_real: torch.Tensor


def _runs(classes):
    """Contiguous (lo, hi, class) runs of a class list."""
    out, lo = [], 0
    for i in range(1, len(classes) + 1):
        if i == len(classes) or classes[i] != classes[lo]:
            out.append((lo, i, classes[lo]))
            lo = i
    return out


def qc_tables(plan, lay, device) -> QCTables:
    """Kernel and twin tables of a QCPlan over the slot-major layout."""
    Z = plan.Z
    z = np.arange(Z)
    max_dc, max_dv = max(plan.cn_degrees), max(plan.vn_degrees)
    R_cn, R_vn = len(plan.cn_rows), len(plan.vn_cols)
    cn_src = np.zeros((R_cn, max_dc), np.int64)
    cn_shift = np.zeros((R_cn, max_dc), np.int64)
    cn_dst = np.zeros((R_cn, max_dc), np.int64)
    cn_deg = np.zeros(R_cn, np.int64)
    cn_cls = []
    for r, (ci, src, dst) in enumerate(plan.cn_rows):
        cn_cls.append(ci)
        cn_deg[r] = len(src)
        for k, (vbase, s) in enumerate(src):
            # m_cn[dst + z] = m_vn[src + (z - s) % Z] (qc_kernels.py:572)
            cn_src[r, k], cn_shift[r, k] = vbase, (Z - s) % Z
            cn_dst[r, k] = dst[k]
    vn_src = np.zeros((R_vn, max_dv), np.int64)
    vn_shift = np.zeros((R_vn, max_dv), np.int64)
    vn_dst = np.zeros((R_vn, max_dv), np.int64)
    vn_node = np.zeros(R_vn, np.int64)
    vn_cls = np.zeros(R_vn, np.int64)
    for r, (ci, nbase, src, dst) in enumerate(plan.vn_cols):
        vn_cls[r], vn_node[r] = ci, nbase
        for k, (cbase, s) in enumerate(src):
            # m_vn[dst + z] = m_cn[src + (z + s) % Z] (qc_kernels.py:905)
            vn_src[r, k], vn_shift[r, k] = cbase, s % Z
            vn_dst[r, k] = dst[k]

    def rows(base, shift, r0, r1, d):
        # (d, (r1 - r0) * Z): slot-major gather rows of a run of block-rows
        b = base[r0:r1, :d].T[:, :, None]
        s = shift[r0:r1, :d].T[:, :, None]
        return (b + (z[None, None, :] + s) % Z).reshape(d, -1)

    zero = np.zeros_like(cn_shift)
    cn_plain = []
    for lo, hi, ci in _runs(cn_cls):
        d = plan.cn_degrees[ci]
        cn_plain.append((_i64(rows(cn_src, cn_shift, lo, hi, d), device),
                         _i64(rows(cn_dst, zero, lo, hi, d), device)))
    vzero = np.zeros_like(vn_shift)
    vn_plain = []
    vn_runs = tuple((lo, hi, int(ci)) for lo, hi, ci in _runs(list(vn_cls)))
    for lo, hi, ci in vn_runs:
        d = plan.vn_degrees[ci]
        node = (vn_node[lo:hi, None] + z[None, :]).reshape(-1)
        vn_plain.append((int(ci), _i64(rows(vn_src, vn_shift, lo, hi, d), device),
                         _i64(rows(vn_dst, vzero, lo, hi, d), device),
                         _i64(node, device)))

    return QCTables(
        Z=Z, rows_cn=lay.num_edges_cn, rows_vn=lay.num_edges_vn,
        nvar_pad=lay.nvar_pad, max_dc=max_dc, max_dv=max_dv,
        cn_src=_i32(cn_src, device), cn_shift=_i32(cn_shift, device),
        cn_dst=_i32(cn_dst, device), cn_deg=_i32(cn_deg, device),
        vn_src=_i32(vn_src, device), vn_shift=_i32(vn_shift, device),
        vn_dst=_i32(vn_dst, device), vn_node=_i32(vn_node, device),
        vn_cls=_i32(vn_cls, device), vn_runs=vn_runs,
        cn_runs=tuple((lo, hi, int(d)) for lo, hi, d in _runs(list(cn_deg))),
        cn_plain=cn_plain,
        vn_plain=vn_plain,
        cn_real=_i64(_real_rows(lay.cn_blocks), device),
        vn_real=_i64(_real_rows(lay.vn_blocks), device),
        node_real=_i64(_real_nodes(lay.vn_blocks), device))


# ---------------------------------------------------------------------------
# std-layout tables (graphs without circulant structure)
# ---------------------------------------------------------------------------
STD_CLS_COLS = 5  # node_start, n_pad, num_nodes, degree, edge_start


@dataclass
class StdTables:
    rows_cn: int     # CN-grouped edge rows (slot-major, padded)
    rows_vn: int     # VN-grouped edge rows
    nvar_pad: int
    nchk_pad: int
    max_dc: int
    max_dv: int
    # per degree class (node_start, n_pad, num_nodes, degree, edge_start):
    # node row g of class c, slot k lives at edge row
    # edge_start + k * n_pad + (g - node_start); rows with
    # g - node_start >= num_nodes are padding
    cn_cls: torch.Tensor   # (C_cn * STD_CLS_COLS,) int32
    vn_cls: torch.Tensor   # (C_vn * STD_CLS_COLS,) int32
    cn_blocks: tuple       # the layout's Block records (plain twins)
    vn_blocks: tuple
    # row gathers: m_cn = m_vn[perm_v2c], m_vn = m_cn[perm_c2v]
    # (arith_decoder.py _permute_v2c / _permute_c2v without a QC plan);
    # padding rows point at row 0
    perm_v2c: torch.Tensor  # (rows_cn,) int32
    perm_c2v: torch.Tensor  # (rows_vn,) int32
    # the inverse of perm_c2v on the real rows: CN-grouped row -> the
    # VN-grouped row of the same edge (equal to perm_v2c there), -1 at
    # padding rows; the CN kernels read and write the VN-grouped arrays
    # through it
    inv_c2v: torch.Tensor   # (rows_cn,) int32
    # real (non-padding) rows, for comparisons
    cn_real: torch.Tensor
    vn_real: torch.Tensor
    node_real: torch.Tensor


def _real_rows(blocks) -> np.ndarray:
    return np.concatenate([
        blk.edge_start + k * blk.n_pad + np.arange(blk.num_nodes)
        for blk in blocks for k in range(blk.degree)])


def _real_nodes(blocks) -> np.ndarray:
    return np.concatenate([blk.node_start + np.arange(blk.num_nodes)
                           for blk in blocks])


def std_tables(lay, device) -> StdTables:
    """Kernel and twin tables of the slot-major layout `lay` for the
    std-layout passes."""
    def cls(blocks):
        return _i32([[b.node_start, b.n_pad, b.num_nodes, b.degree,
                      b.edge_start] for b in blocks], device).reshape(-1)

    vn_real = _real_rows(lay.vn_blocks)
    inv_c2v = np.full(lay.num_edges_cn, -1, np.int64)
    inv_c2v[np.asarray(lay.perm_c2v)[vn_real]] = vn_real
    return StdTables(
        rows_cn=lay.num_edges_cn, rows_vn=lay.num_edges_vn,
        nvar_pad=lay.nvar_pad, nchk_pad=lay.nchk_pad,
        max_dc=max(b.degree for b in lay.cn_blocks),
        max_dv=max(b.degree for b in lay.vn_blocks),
        cn_cls=cls(lay.cn_blocks), vn_cls=cls(lay.vn_blocks),
        cn_blocks=tuple(lay.cn_blocks), vn_blocks=tuple(lay.vn_blocks),
        perm_v2c=_i32(lay.perm_v2c, device), perm_c2v=_i32(lay.perm_c2v, device),
        inv_c2v=_i32(inv_c2v, device),
        cn_real=_i64(_real_rows(lay.cn_blocks), device),
        vn_real=_i64(vn_real, device),
        node_real=_i64(_real_nodes(lay.vn_blocks), device))


# ---------------------------------------------------------------------------
# value-domain decoder tensors
# ---------------------------------------------------------------------------
@dataclass
class ArithTensors:
    leaf_cha: torch.Tensor     # (Nq_Cha,) message dtype
    leaf_msg0: torch.Tensor    # (Nq,) message dtype
    vn_nodes: torch.Tensor     # (nvar_pad,) grouped row -> variable id
    vn_node_pos: torch.Tensor  # (nvar,) variable id -> grouped row
    cn_var_pos: torch.Tensor   # (E_cn,) CN-grouped edge -> grouped node row
    edge_node: torch.Tensor    # (E_vn,) VN-grouped edge -> grouped node row
    perm_c2v: torch.Tensor     # (E_vn,) VN-grouped edge -> CN-grouped edge
    cn_padmask: list           # per CN block (n_pad,) bool, True at padding


def arith_tensors(spec, lay, device) -> ArithTensors:
    dt = torch_dtype(spec.dtype)
    edge_node = np.concatenate([
        np.tile(blk.node_start + np.arange(blk.n_pad), blk.degree)
        for blk in lay.vn_blocks])
    return ArithTensors(
        leaf_cha=torch.as_tensor(np.asarray(spec.leaf_cha), device=device).to(dt),
        leaf_msg0=torch.as_tensor(np.asarray(spec.leaf_msg0), device=device).to(dt),
        vn_nodes=_i64(lay.vn_nodes, device),
        vn_node_pos=_i64(lay.vn_node_pos, device),
        cn_var_pos=_i64(lay.cn_var_pos, device),
        edge_node=_i64(edge_node, device),
        perm_c2v=_i64(lay.perm_c2v, device),
        cn_padmask=[torch.as_tensor(np.arange(blk.n_pad) >= blk.num_nodes,
                                    device=device) for blk in lay.cn_blocks])


# ---------------------------------------------------------------------------
# label-domain table decoder
# ---------------------------------------------------------------------------
@dataclass
class FastTables:
    var_kind: list   # per VN block: "composed" | "program"
    var_progs: list  # per block: TreeProgram (program path) or None
    var_xs: list     # per block: (T-1, n) int32, or per-op list of (T-1, len)
    dec_kind: list
    dec_tab: list    # per block: composed decision table or None
    dec_progs: list  # per block: (TreeProgram, [op tables]) or None
    perm_v2c: torch.Tensor
    perm_c2v: torch.Tensor
    vn_nodes: torch.Tensor
    vn_node_pos: torch.Tensor
    cn_var_pos: torch.Tensor
    vn_loo: dict     # degree -> (d, d) leave-one-out index over d+1 inputs
    # CN LUT trees (codecs that are not min-LUT; else None): per CN block a
    # TreeProgram and per op its tables stacked over all T iterations
    chk_progs: list
    chk_xs: list
    cn_loo: dict     # degree -> (d, d - 1) leave-one-out index over d inputs
    bases: dict      # degree -> (d,) int32 mixed-radix bases
    out_bits: int


def fast_tables(codec, lay, Nq, device) -> FastTables:
    """fast_decoder.py:135-243."""
    T, Nqc = codec.max_iters, codec.Nq_Cha
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    var_kind, var_progs, var_xs = [], [], []
    for blk in lay.vn_blocks:
        d = blk.degree
        kinds, payloads = [], []
        for ii in range(T - 1):
            kind, payload = fast_layout.var_tree_tables(
                codec.var_tree(ii, d), d, Nq, Nqc, Nq)
            kinds.append(kind)
            payloads.append(payload)
        if T == 1:
            var_kind.append("composed")
            var_progs.append(None)
            var_xs.append(torch.zeros((0, 1), dtype=torch.int32, device=device))
        elif all(k == "composed" for k in kinds):
            var_kind.append("composed")
            var_progs.append(None)
            var_xs.append(t32(np.stack(payloads)))
        else:
            progs = [p if k == "program"
                     else tree_layout.tree_program(codec.var_tree(ii, d))
                     for ii, (k, p) in enumerate(zip(kinds, payloads))]
            key0 = progs[0].structure_key()
            if any(p.structure_key() != key0 for p in progs[1:]):
                raise ValueError("fast decoder: var tree structure varies over iterations")
            var_kind.append("program")
            var_progs.append(progs[0])
            var_xs.append([t32(np.stack([p.ops[oi].table for p in progs]))
                           for oi in range(len(progs[0].ops))])

    chk_progs = chk_xs = None
    if not codec.min_lut:
        chk_progs, chk_xs = [], []
        for blk in lay.cn_blocks:
            progs = [tree_layout.tree_program(codec.chk_tree(ii, blk.degree))
                     for ii in range(T)]
            key0 = progs[0].structure_key()
            if any(p.structure_key() != key0 for p in progs[1:]):
                raise ValueError("fast decoder: chk tree structure varies over iterations")
            chk_progs.append(progs[0])
            chk_xs.append([t32(np.stack([p.ops[oi].table for p in progs]))
                           for oi in range(len(progs[0].ops))])

    dec_kind, dec_tab, dec_progs = [], [], []
    for blk in lay.vn_blocks:
        d = blk.degree
        prog = tree_layout.tree_program(codec.var_tree(T - 1, d))
        if fast_layout.composed_entries(d, Nq, Nqc) <= fast_layout.MAX_COMPOSED_ENTRIES:
            dec_kind.append("composed")
            dec_tab.append(t32(fast_layout.compose_dec_table(prog, d, Nq, Nqc)))
            dec_progs.append(None)
        else:
            dec_kind.append("program")
            dec_tab.append(None)
            dec_progs.append((prog, [t32(op.table) for op in prog.ops]))
    degs = sorted({blk.degree for blk in lay.vn_blocks})
    return FastTables(
        var_kind=var_kind, var_progs=var_progs, var_xs=var_xs,
        dec_kind=dec_kind, dec_tab=dec_tab, dec_progs=dec_progs,
        perm_v2c=_i64(lay.perm_v2c, device), perm_c2v=_i64(lay.perm_c2v, device),
        vn_nodes=_i64(lay.vn_nodes, device),
        vn_node_pos=_i64(lay.vn_node_pos, device),
        cn_var_pos=_i64(lay.cn_var_pos, device),
        vn_loo={d: _i64(tree_layout.leave_one_out_idx(d + 1, d), device)
                for d in degs},
        chk_progs=chk_progs, chk_xs=chk_xs,
        cn_loo={blk.degree: _i64(tree_layout.leave_one_out_idx(
            blk.degree, blk.degree), device) for blk in lay.cn_blocks},
        bases={d: t32(Nq ** np.arange(d)) for d in degs},
        out_bits=max(1, int(np.ceil(np.log2(Nq)))))
