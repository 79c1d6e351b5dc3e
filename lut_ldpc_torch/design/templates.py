"""LUT tree template factory: Array[iteration][degree] of tree skeletons.

Mirrors get_lut_tree_templates (reference src/LDPC_DE.cpp:1124-1290):
auto modes generate fresh trees per iteration (last iteration becomes a
decision tree with dv+1 leaves and output resolution 2); file mode reads the
tree-structure INI dialect (sections [var_iter_NNN]/[chk_iter_NNN]/[DT],
keys var_deg_NNN/chk_deg_NNN; a missing iteration section inherits the
previous one).
"""

from __future__ import annotations

import configparser

import numpy as np

from ..core.trees import CHKTREE, DECTREE, VARTREE, LUTTree

AUTO_MODES = ("auto_bin_balanced", "auto_bin_high", "root_only")


def get_lut_tree_templates(
    tree_method: str,
    ens,
    Nq_Msg: np.ndarray,
    Nq_Cha: int,
    min_lut: bool,
):
    """Returns (var_luts, chk_luts): lists [iteration][active degree].

    tree_method: one of AUTO_MODES or 'filename=<path>'.
    Nq_Msg: per-iteration message resolutions (length = number of iterations).
    """
    Nq_Msg = np.asarray(Nq_Msg, dtype=np.int64)
    max_iters = len(Nq_Msg)
    var_deg = ens.degree_lam
    chk_deg = ens.degree_rho

    mode, _, filename = tree_method.partition("=")
    if mode == "filename":
        return _templates_from_file(filename, ens, Nq_Msg, Nq_Cha, min_lut)
    if mode not in AUTO_MODES or filename:
        raise ValueError(f"could not parse tree_method {tree_method!r}")

    # Nq_out of the final var update is 2 (hard decision); intermediate
    # iterations chain Nq_Msg[ii] -> Nq_Msg[ii+1] (with an implicit terminal
    # entry appended by the DE engine at evolve time).
    def msg_out(ii):
        return int(Nq_Msg[ii + 1]) if ii + 1 < max_iters else 2

    var_luts = []
    for ii in range(max_iters):
        row = []
        for d in var_deg:
            if ii == max_iters - 1:
                t = LUTTree.auto(int(d) + 1, DECTREE, mode)
                t.set_resolution(int(Nq_Msg[ii]), 2, Nq_Cha)
            else:
                t = LUTTree.auto(int(d), VARTREE, mode)
                t.set_resolution(int(Nq_Msg[ii]), int(Nq_Msg[ii + 1]), Nq_Cha)
            row.append(t)
        var_luts.append(row)

    chk_luts = []
    if not min_lut:
        for ii in range(max_iters):
            row = []
            for d in chk_deg:
                t = LUTTree.auto(int(d) - 1, CHKTREE, mode)
                t.set_resolution(int(Nq_Msg[ii]), int(Nq_Msg[ii]))
                row.append(t)
            chk_luts.append(row)
    return var_luts, chk_luts


def _templates_from_file(filename: str, ens, Nq_Msg, Nq_Cha: int, min_lut: bool):
    """Tree-structure INI (LDPC_DE.cpp:1146-1250)."""
    max_iters = len(Nq_Msg)
    var_deg = ens.degree_lam
    chk_deg = ens.degree_rho
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.optionxform = str  # preserve case
    with open(filename) as f:
        cp.read_string(f.read())

    def get_tree(section: str, key: str) -> str | None:
        if cp.has_section(section) and cp.has_option(section, key):
            return cp.get(section, key).strip()
        return None

    var_luts = [None] * max_iters
    # iteration 0 must exist
    row0 = []
    for d in var_deg:
        s = get_tree("var_iter_000", f"var_deg_{int(d):03d}")
        if s is None:
            raise ValueError(f"missing var tree for degree {d} at iteration 0")
        t = LUTTree.from_template(s, VARTREE)
        if t.num_leaves != d:
            raise ValueError(f"var tree leaves != degree {d}")
        t.set_resolution(int(Nq_Msg[0]), int(Nq_Msg[1]) if max_iters > 1 else 2, Nq_Cha)
        row0.append(t)
    var_luts[0] = row0
    for ii in range(1, max_iters - 1):
        sec = f"var_iter_{ii:03d}"
        if cp.has_section(sec):
            row = []
            for d in var_deg:
                s = get_tree(sec, f"var_deg_{int(d):03d}")
                if s is None:
                    raise ValueError(f"missing var tree for degree {d} at iteration {ii}")
                t = LUTTree.from_template(s, VARTREE)
                if t.num_leaves != d:
                    raise ValueError(f"var tree leaves != degree {d}")
                t.set_resolution(int(Nq_Msg[ii]), int(Nq_Msg[ii + 1]), Nq_Cha)
                row.append(t)
            var_luts[ii] = row
        else:
            var_luts[ii] = [t.copy() for t in var_luts[ii - 1]]
    # decision trees
    rowd = []
    for d in var_deg:
        s = get_tree("DT", f"var_deg_{int(d):03d}")
        if s is None:
            raise ValueError(f"missing decision tree for degree {d}")
        t = LUTTree.from_template(s, DECTREE)
        if t.num_leaves != d + 1:
            raise ValueError(f"decision tree leaves != degree {d}+1")
        t.set_resolution(int(Nq_Msg[max_iters - 1]), 2, Nq_Cha)
        rowd.append(t)
    if max_iters > 1:
        var_luts[max_iters - 1] = rowd
    else:
        var_luts[0] = rowd

    chk_luts = []
    if not min_lut:
        chk_luts = [None] * max_iters
        row0 = []
        for d in chk_deg:
            s = get_tree("chk_iter_000", f"chk_deg_{int(d):03d}")
            if s is None:
                raise ValueError(f"missing chk tree for degree {d} at iteration 0")
            t = LUTTree.from_template(s, CHKTREE)
            if t.num_leaves != d - 1:
                raise ValueError(f"chk tree leaves != degree {d}-1")
            t.set_resolution(int(Nq_Msg[0]), int(Nq_Msg[0]))
            row0.append(t)
        chk_luts[0] = row0
        for ii in range(1, max_iters):
            sec = f"chk_iter_{ii:03d}"
            if cp.has_section(sec):
                row = []
                for d in chk_deg:
                    s = get_tree(sec, f"chk_deg_{int(d):03d}")
                    if s is None:
                        raise ValueError(f"missing chk tree for degree {d} at iteration {ii}")
                    t = LUTTree.from_template(s, CHKTREE)
                    if t.num_leaves != d - 1:
                        raise ValueError(f"chk tree leaves != degree {d}-1")
                    t.set_resolution(int(Nq_Msg[ii]), int(Nq_Msg[ii]), Nq_Cha)
                    row.append(t)
                chk_luts[ii] = row
            else:
                chk_luts[ii] = [t.copy() for t in chk_luts[ii - 1]]
    return var_luts, chk_luts
