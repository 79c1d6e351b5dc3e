"""Tanner-graph layout for the TPU decoder.

The reference decoder walks the graph edge by edge with scalar loops
(reference src/LDPC_Code_LUT.cpp:488-541, 259-353).  On TPU we instead
precompute *static, degree-grouped dense index arrays* once per code:

- edges are enumerated VN-major (all edges of variable 0, then 1, ...; within
  a variable, ascending check index) -- the same enumeration the reference
  uses for its `msgs` array, which keeps artifacts interchangeable;
- for each active VN degree d, `vn_edge_idx[d]` is an (n_d, d) int32 array of
  edge ids and `vn_node_idx[d]` the (n_d,) variable ids, so a VN update is a
  dense gather -> (B, n_d, d) compute -> scatter;
- for each active CN degree d, `cn_edge_idx[d]` / `cn_node_idx[d]` likewise
  (edge ids within a check sorted by variable id, matching the reference's
  cn_msg_idx construction).

All gathers use a flat (B, E) message tensor; the index arrays are small and
VMEM-resident, which is what makes the message-passing sweep map onto the
TPU's vector units instead of scalar address arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alist import read_alist_cols

__all__ = ["TannerGraph"]


@dataclass
class TannerGraph:
    nvar: int
    nchk: int
    num_edges: int
    dv_vec: np.ndarray  # (nvar,) variable degrees
    dc_vec: np.ndarray  # (nchk,) check degrees
    # degree-grouped index arrays: dict degree -> array
    vn_degrees: np.ndarray  # sorted active VN degrees
    cn_degrees: np.ndarray  # sorted active CN degrees
    vn_edge_idx: dict  # d -> (n_d, d) int32 edge ids (VN-major)
    vn_node_idx: dict  # d -> (n_d,) int32 variable ids
    cn_edge_idx: dict  # d -> (m_d, d) int32 edge ids (VN-major)
    cn_node_idx: dict  # d -> (m_d,) int32 check ids
    cn_var_idx: dict  # d -> (m_d, d) int32 variable ids (syndrome eval)

    @classmethod
    def from_cols(cls, cols: list[np.ndarray], nvar: int, nchk: int) -> "TannerGraph":
        dv_vec = np.array([len(c) for c in cols], dtype=np.int64)
        num_edges = int(dv_vec.sum())

        # VN-major edge enumeration; record (check -> list of edge ids, var ids)
        chk_edges: list[list[int]] = [[] for _ in range(nchk)]
        chk_vars: list[list[int]] = [[] for _ in range(nchk)]
        e = 0
        for v in range(nvar):
            for c in cols[v]:  # ascending check ids
                chk_edges[c].append(e)
                chk_vars[c].append(v)
                e += 1
        dc_vec = np.array([len(x) for x in chk_edges], dtype=np.int64)

        # degree groups
        vn_degrees = np.unique(dv_vec)
        cn_degrees = np.unique(dc_vec)
        vn_edge_idx, vn_node_idx = {}, {}
        edge_starts = np.concatenate([[0], np.cumsum(dv_vec)])
        for d in vn_degrees:
            nodes = np.nonzero(dv_vec == d)[0]
            idx = edge_starts[nodes][:, None] + np.arange(d)[None, :]
            vn_edge_idx[int(d)] = idx.astype(np.int32)
            vn_node_idx[int(d)] = nodes.astype(np.int32)
        cn_edge_idx, cn_node_idx, cn_var_idx = {}, {}, {}
        for d in cn_degrees:
            nodes = np.nonzero(dc_vec == d)[0]
            cn_edge_idx[int(d)] = np.array(
                [chk_edges[c] for c in nodes], dtype=np.int32
            ).reshape(len(nodes), d)
            cn_var_idx[int(d)] = np.array(
                [chk_vars[c] for c in nodes], dtype=np.int32
            ).reshape(len(nodes), d)
            cn_node_idx[int(d)] = nodes.astype(np.int32)

        return cls(
            nvar=nvar,
            nchk=nchk,
            num_edges=num_edges,
            dv_vec=dv_vec,
            dc_vec=dc_vec,
            vn_degrees=vn_degrees,
            cn_degrees=cn_degrees,
            vn_edge_idx=vn_edge_idx,
            vn_node_idx=vn_node_idx,
            cn_edge_idx=cn_edge_idx,
            cn_node_idx=cn_node_idx,
            cn_var_idx=cn_var_idx,
        )

    @classmethod
    def from_alist(cls, path: str) -> "TannerGraph":
        cols, nvar, nchk = read_alist_cols(path)
        return cls.from_cols(cols, nvar, nchk)

    @classmethod
    def from_dense(cls, H: np.ndarray) -> "TannerGraph":
        H = np.asarray(H)
        nchk, nvar = H.shape
        cols = [np.nonzero(H[:, v])[0].astype(np.int64) for v in range(nvar)]
        return cls.from_cols(cols, nvar, nchk)

    # -- convenience ---------------------------------------------------------
    @property
    def phantoms(self) -> tuple:
        """Phantom completion edges (core/qc.py qc_expand): present in the
        index arrays but NOT part of the true matrix.  to_dense and the
        empirical ensemble describe the TRUE matrix; decoders either pin
        these edges (exact true-matrix semantics, decoder/codec.py
        decode_ref) or reject the graph."""
        return getattr(self, "qc_phantoms", ())

    def to_dense(self) -> np.ndarray:
        """(nchk, nvar) uint8 parity-check matrix of the TRUE code
        (phantom completion edges excluded)."""
        H = np.zeros((self.nchk, self.nvar), dtype=np.uint8)
        for d in self.cn_degrees:
            d = int(d)
            H[self.cn_node_idx[d][:, None], self.cn_var_idx[d]] = 1
        for p in self.phantoms:
            H[p["chk"], p["var"]] = 0
        return H

    def var_llr_edge_expand(self) -> np.ndarray:
        """(E,) int32: variable id owning each VN-major edge (for LLR gathers)."""
        return np.repeat(np.arange(self.nvar, dtype=np.int32), self.dv_vec)

    def rate(self) -> float:
        return 1.0 - self.nchk / self.nvar

    def empirical_ensemble(self):
        from .ensemble import empirical_ensemble

        dv, dc = self.dv_vec, self.dc_vec
        if self.phantoms:  # true-matrix degrees
            dv = dv.copy()
            dc = dc.copy()
            for p in self.phantoms:
                dv[p["var"]] -= 1
                dc[p["chk"]] -= 1
        return empirical_ensemble(dv, dc)
