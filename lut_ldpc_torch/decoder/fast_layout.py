"""Degree-grouped permutation layout + composed LUTs for the fast decoder.

Two ideas turn the message-passing sweep into a handful of dense streaming
ops (this is the TPU-native re-design of the reference's per-edge walks,
reference src/LDPC_Code_LUT.cpp:259-353 — not a translation of them):

1. **Permutation layout, no scatters.**  Edges live in two static orders:
   VN-grouped (variables sorted by degree, each variable's edges contiguous)
   and CN-grouped (likewise for checks).  Each order is partitioned into
   per-degree *contiguous slices* that reshape to dense (nodes, degree)
   blocks for free.  One iteration is then:
   gather(perm_v2c) -> CN blocks -> gather(perm_c2v) -> VN blocks —
   two (B, E) permutation gathers and elementwise block math.  The
   reference's cn_msg_idx scatter/gather pair (cpp:488-541) disappears.

2. **Composed leave-one-out LUTs.**  A whole degree-d VN tree update —
   including all d leave-one-out evaluations — is precomposed into ONE
   table over the joint input label (d messages + channel), with the d
   4-bit outputs packed into one integer.  A VN update becomes a single
   vector gather from a VMEM-resident table plus shift/mask unpacking,
   instead of d tree walks of 2-input LUT lookups.  Tables are composed
   only while they fit (Nq^d * Nq_Cha entries <= 2^20); high-degree nodes
   fall back to per-op TreeProgram evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.tanner import TannerGraph
from .layout import TreeProgram, leave_one_out_idx, tree_program

__all__ = [
    "GroupedLayout",
    "QCPlan",
    "compose_var_loo_table",
    "compose_dec_table",
    "MAX_COMPOSED_ENTRIES",
]

MAX_COMPOSED_ENTRIES = 1 << 20


@dataclass(frozen=True)
class Block:
    degree: int
    node_start: int  # start in grouped node order (padded coordinates)
    num_nodes: int  # REAL nodes in this block
    edge_start: int  # start in grouped edge order (padded coordinates)
    n_pad: int = 0  # padded node count (== num_nodes when align == 1)


@dataclass(frozen=True)
class QCPlan:
    """Roll decomposition of a QC graph's message permutations over the
    slot-major padded edge arrays, in two equivalent views:

    - ``copies``: flat (vn_start, cn_start, shift) descriptors, one per
      circulant, sorted by cn_start; m_cn[cn_start + z'] =
      m_vn[vn_start + (z' - shift) % Z] for z' in [0, Z).  Consumed by the
      XLA scan-copy permutes.
    - ``cn_rows`` / ``vn_cols``: per-grid-block static DMA tables for the
      fused Pallas kernels.  cn_rows[i] = (class_idx, ((vn_base, shift),
      ...) one per CN slot, (cn_base, ...) one per slot) for check block i
      in CN-grouped layout-block order; vn_cols[j] likewise for variable
      block j with node_base (flat row into the grouped node arrays) for
      the channel/bits planes.

    Validated exactly against the layout's perm_v2c at construction."""

    Z: int
    copies: tuple  # ((vn_start, cn_start, shift), ...)
    cn_rows: tuple  # ((class_idx, ((vn_base, s), ...), (cn_base, ...)), ...)
    vn_cols: tuple  # ((class_idx, node_base, ((cn_base, s), ...), (vn_base, ...)), ...)
    cn_degrees: tuple  # per CN class degree
    vn_degrees: tuple  # per VN class degree


class GroupedLayout:
    """Static index arrays for the permutation-form decoder.

    slot_major=True lays each degree block out with the edge-slot axis
    OUTERMOST (block range reshapes to (d, n, B)), so per-slot reductions
    and leave-one-out arrangements are contiguous slices — the layout the
    TPU's (sublane, lane) tiling wants.  slot_major=False keeps (n, d, B)
    node-major order.  The permutations absorb the difference.

    align > 1 pads every block's node count to a multiple of `align`, so
    each per-slot plane starts on a TPU tile boundary (int16 tiles are
    (16, 128): 16-aligned slot sizes make the (E, B) <-> (d, n_pad, B)
    reshapes free bitcasts instead of physical relayouts).  Padded node /
    edge rows carry garbage values by design; permutation entries for them
    point at row 0 and all reductions must mask with the blocks'
    [num_nodes, n_pad) ranges.  FastLUTDecoder keeps align=1.
    """

    def __init__(self, graph: TannerGraph, slot_major: bool = False,
                 align: int = 1):
        g = graph
        self.nvar = g.nvar
        self.nchk = g.nchk
        self.num_edges = g.num_edges
        self.slot_major = slot_major
        self.align = align

        def pad(n: int) -> int:
            return -(-n // align) * align

        def block_edges(edge_idx, n_pad):
            # edge_idx (n, d): grouped order within the block; -1 rows pad
            n, d = edge_idx.shape
            if n_pad > n:
                fill = np.full((n_pad - n, d), -1, dtype=edge_idx.dtype)
                edge_idx = np.concatenate([edge_idx, fill], axis=0)
            return edge_idx.T.reshape(-1) if slot_major else edge_idx.reshape(-1)

        # --- VN-grouped order -------------------------------------------
        vn_blocks: list[Block] = []
        vn_nodes = []  # natural var ids in grouped PADDED order (-1 pads)
        vnG_edge_orig = []  # grouped edge position -> original edge id (-1 pads)
        self.vn_node_pos = np.empty(g.nvar, dtype=np.int32)
        npos = epos = 0
        for d in g.vn_degrees:
            d = int(d)
            nodes = g.vn_node_idx[d]
            n, n_pad = len(nodes), pad(len(nodes))
            vn_blocks.append(Block(d, npos, n, epos, n_pad))
            vn_nodes.append(np.concatenate(
                [nodes, np.full(n_pad - n, -1, dtype=nodes.dtype)]))
            self.vn_node_pos[nodes] = npos + np.arange(n, dtype=np.int32)
            vnG_edge_orig.append(block_edges(g.vn_edge_idx[d], n_pad))
            npos += n_pad
            epos += n_pad * d
        self.vn_blocks = vn_blocks
        self.nvar_pad = npos
        self.num_edges_vn = epos
        vn_nodes = np.concatenate(vn_nodes)  # (nvar_pad,)
        self.vn_nodes = np.where(vn_nodes < 0, 0, vn_nodes)
        vnG_edge_orig = np.concatenate(vnG_edge_orig)  # (E_vn_pad,)
        # grouped edge position -> original edge id (-1 at pad rows); kept
        # for cross-layout bridging (hybrid decoder: padded slot-major
        # arith state -> unpadded node-major table state)
        self.vn_edge_orig = vnG_edge_orig

        # --- CN-grouped order -------------------------------------------
        cn_blocks: list[Block] = []
        cnG_edge_orig = []
        cn_var_natural = []  # variable id of each cn-grouped edge (-1 pads)
        cn_nodes = []  # natural check ids in grouped PADDED order (-1 pads)
        npos = epos = 0
        for d in g.cn_degrees:
            d = int(d)
            nodes = g.cn_node_idx[d]
            n, n_pad = len(nodes), pad(len(nodes))
            cn_blocks.append(Block(d, npos, n, epos, n_pad))
            cn_nodes.append(np.concatenate(
                [nodes, np.full(n_pad - n, -1, dtype=nodes.dtype)]))
            cnG_edge_orig.append(block_edges(g.cn_edge_idx[d], n_pad))
            cn_var_natural.append(block_edges(g.cn_var_idx[d], n_pad))
            npos += n_pad
            epos += n_pad * d
        self.cn_blocks = cn_blocks
        # kept with -1 pads (vn_nodes clamps pads to 0 for gather use)
        self.cn_nodes = np.concatenate(cn_nodes)
        self.nchk_pad = npos
        self.num_edges_cn = epos
        cnG_edge_orig = np.concatenate(cnG_edge_orig)

        # --- permutations ------------------------------------------------
        inv_vnG = np.empty(g.num_edges, dtype=np.int64)
        inv_vnG[vnG_edge_orig[vnG_edge_orig >= 0]] = np.nonzero(
            vnG_edge_orig >= 0
        )[0]
        inv_cnG = np.empty(g.num_edges, dtype=np.int64)
        inv_cnG[cnG_edge_orig[cnG_edge_orig >= 0]] = np.nonzero(
            cnG_edge_orig >= 0
        )[0]
        # cn-grouped position -> vn-grouped position of the same edge
        self.perm_v2c = np.where(
            cnG_edge_orig >= 0, inv_vnG[cnG_edge_orig], 0
        ).astype(np.int32)
        # vn-grouped position -> cn-grouped position
        self.perm_c2v = np.where(
            vnG_edge_orig >= 0, inv_cnG[vnG_edge_orig], 0
        ).astype(np.int32)

        # grouped-bit-vector positions of each cn-grouped edge's variable
        # (for the final syndrome check on decision bits)
        cn_var_natural = np.concatenate(cn_var_natural)
        self.cn_var_pos = np.where(
            cn_var_natural >= 0, self.vn_node_pos[cn_var_natural], 0
        ).astype(np.int32)

    # ------------------------------------------------------------------
    def qc_plan(self, qc):
        """Flat roll decomposition of perm_v2c for a quasi-cyclic graph,
        valid for ANY mix of degree classes (irregular QC codes,
        core/qc.py qc_generate_irregular): a list of (vn_start, cn_start,
        shift) copy descriptors, each meaning

            m_cn[cn_start + z'] = m_vn[vn_start + (z' - shift) % Z]

        for z' in [0, Z), with vn_start/cn_start flat row offsets into the
        slot-major padded edge arrays.  Descriptors are sorted by cn_start
        and cover every real CN-grouped row exactly once; uncovered rows
        are padding.  Requires a slot-major layout, every circulant in a
        distinct (row, column)-block pair (so per-node sorted edge order
        equals circulant block order uniformly in z), and Z | every block's
        node count.  VALIDATED exactly against perm_v2c; returns None when
        the layout does not admit the decomposition (callers fall back to
        the gather path)."""
        if not self.slot_major:
            return None
        Z = qc.Z
        circ = qc.circulants()
        col_circs: dict[int, list] = {}
        row_circs: dict[int, list] = {}
        for i, j, s in circ:
            col_circs.setdefault(j, []).append((i, s))
            row_circs.setdefault(i, []).append((j, s))
        # weight-2 cells are allowed: the graph must be built with
        # slot-order edge lists (qc_expand), i.e. per-node order ascending
        # (block, shift) uniformly in z; the exact perm_v2c validation
        # below rejects any graph whose order does not match
        for v in col_circs.values():
            v.sort()
        for v in row_circs.values():
            v.sort()

        # block lookup: (class index, edge/node bases, position in class)
        def block_info(blocks, node_ids, nblocks, zsize):
            """For each grid block id b, (class_idx, plane_e0, n_pad,
            node_start, pos) such that slot k of grid block b starts at
            flat edge row plane_e0 + k * n_pad + pos * zsize and its nodes
            at grouped node row node_start + pos * zsize.  None when grid
            blocks do not tile the classes."""
            info = {}
            for ci, (blk, ids) in enumerate(zip(blocks, node_ids)):
                if blk.num_nodes % zsize:
                    return None
                # class node list must be consecutive zsize-runs of blocks
                real = ids[: blk.num_nodes]
                runs = real.reshape(-1, zsize)
                if not np.array_equal(
                    runs, runs[:, :1] + np.arange(zsize, dtype=runs.dtype)
                ):
                    return None
                if np.any(runs[:, 0] % zsize):
                    return None
                for pos, b0 in enumerate(runs[:, 0] // zsize):
                    info[int(b0)] = (
                        ci, blk.edge_start, blk.n_pad, blk.node_start, pos
                    )
            return info if len(info) == nblocks else None

        vn_ids = [
            np.asarray(self.vn_nodes)[blk.node_start : blk.node_start + blk.n_pad]
            for blk in self.vn_blocks
        ]
        cn_ids = [
            np.asarray(self.cn_nodes)[blk.node_start : blk.node_start + blk.n_pad]
            for blk in self.cn_blocks
        ]
        vinfo = block_info(self.vn_blocks, vn_ids, qc.nb, Z)
        cinfo = block_info(self.cn_blocks, cn_ids, qc.mb, Z)
        if vinfo is None or cinfo is None:
            return None

        def vn_flat(j, k):
            _, e0v, npv, _, posv = vinfo[j]
            return e0v + k * npv + posv * Z

        def cn_flat(i, l):
            _, e0c, npc, _, posc = cinfo[i]
            return e0c + l * npc + posc * Z

        copies = []
        for j, lst in col_circs.items():
            for k, (i, s) in enumerate(lst):
                l = row_circs[i].index((j, s))
                copies.append((vn_flat(j, k), cn_flat(i, l), s))
        copies.sort(key=lambda t: t[1])

        # exact validation: reconstruct perm_v2c from the plan on covered
        # rows and require full coverage of the real CN-grouped rows
        perm = np.full(self.num_edges_cn, -1, dtype=np.int64)
        zp = np.arange(Z)
        for vs, cs, s in copies:
            if np.any(perm[cs : cs + Z] >= 0):
                return None
            perm[cs : cs + Z] = vs + (zp - s) % Z
        covered = perm >= 0
        nreal = sum(blk.degree * blk.num_nodes for blk in self.cn_blocks)
        if int(covered.sum()) != nreal:
            return None
        if not np.array_equal(
            perm[covered], self.perm_v2c.astype(np.int64)[covered]
        ):
            return None

        # per-grid-block kernel tables, in layout (class, position) order
        cn_order = sorted(range(qc.mb), key=lambda i: (cinfo[i][0], cinfo[i][4]))
        vn_order = sorted(range(qc.nb), key=lambda j: (vinfo[j][0], vinfo[j][4]))
        cn_rows = []
        for i in cn_order:
            ci = cinfo[i][0]
            src = tuple(
                (vn_flat(j, col_circs[j].index((i, s))), s)
                for j, s in row_circs[i]
            )
            dst = tuple(cn_flat(i, l) for l in range(len(row_circs[i])))
            cn_rows.append((ci, src, dst))
        vn_cols = []
        for j in vn_order:
            ci, _, _, node_start, pos = vinfo[j]
            node_base = node_start + pos * Z
            src = tuple(
                (cn_flat(i, row_circs[i].index((j, s))), s)
                for i, s in col_circs[j]
            )
            dst = tuple(vn_flat(j, k) for k in range(len(col_circs[j])))
            vn_cols.append((ci, node_base, src, dst))
        return QCPlan(
            Z=Z,
            copies=tuple(copies),
            cn_rows=tuple(cn_rows),
            vn_cols=tuple(vn_cols),
            cn_degrees=tuple(blk.degree for blk in self.cn_blocks),
            vn_degrees=tuple(blk.degree for blk in self.vn_blocks),
        )



def _mixed_radix_digits(n: int, radices: list[int]) -> np.ndarray:
    """(n, len(radices)) digit table, radix 0 least significant."""
    idx = np.arange(n, dtype=np.int64)
    out = np.empty((n, len(radices)), dtype=np.int32)
    for j, r in enumerate(radices):
        out[:, j] = idx % r
        idx //= r
    return out


def composed_entries(d: int, Nq_msg: int, Nq_cha: int) -> int:
    return Nq_msg**d * Nq_cha


def compose_var_loo_table(
    prog: TreeProgram, d: int, Nq_msg: int, Nq_cha: int, out_bits: int
) -> np.ndarray:
    """Packed leave-one-out table for a degree-d VN tree.

    Entry at joint label (m_0 + Nq*m_1 + ... + Nq^{d-1}*m_{d-1} +
    Nq^d*cha) packs the d leave-one-out outputs, output i in bits
    [i*out_bits, (i+1)*out_bits).  dtype int32 (callers may narrow)."""
    if d * out_bits > 31:
        raise ValueError("compose_var_loo_table: packed width exceeds int32")
    n = composed_entries(d, Nq_msg, Nq_cha)
    inputs = _mixed_radix_digits(n, [Nq_msg] * d + [Nq_cha])
    loo = leave_one_out_idx(d + 1, d)
    packed = np.zeros(n, dtype=np.int64)
    for i in range(d):
        out = prog.eval_np(inputs[:, loo[i]]).astype(np.int64)
        packed |= out << (i * out_bits)
    return packed.astype(np.int32)


def compose_dec_table(prog: TreeProgram, d: int, Nq_msg: int, Nq_cha: int) -> np.ndarray:
    """Hard-decision table for a degree-d decision tree: entry = output
    label (resolution 2) at joint label (d messages + channel)."""
    n = composed_entries(d, Nq_msg, Nq_cha)
    inputs = _mixed_radix_digits(n, [Nq_msg] * d + [Nq_cha])
    return prog.eval_np(inputs).astype(np.int32)


def var_tree_tables(tree, d: int, Nq_msg: int, Nq_cha: int, Nq_out: int):
    """Either ('composed', packed table) or ('program', (prog, tables))."""
    prog = tree_program(tree)
    out_bits = max(1, int(np.ceil(np.log2(Nq_out))))
    if (
        composed_entries(d, Nq_msg, Nq_cha) <= MAX_COMPOSED_ENTRIES
        and d * out_bits <= 31
    ):
        return "composed", compose_var_loo_table(prog, d, Nq_msg, Nq_cha, out_bits)
    return "program", prog
