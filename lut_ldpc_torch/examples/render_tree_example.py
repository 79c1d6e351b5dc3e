"""Render the reference's example LUT tree (port of
examples/render_tree_example.py).

The variable-node tree template ``riim/im/m///iim/m//im/m////c//`` (the
degree-8 example of the reference's trees/README.md) as TikZ through
``LUTTree.tikz_draw`` (core/trees.py, the reference's style), and, where
matplotlib imports, as PNG and PDF from a small tidy layout of the same
structure.

    python -m lut_ldpc_torch.examples.render_tree_example [--out results/trees]
"""

from __future__ import annotations

import argparse
import os

from . import RESULTS

TEMPLATE = "riim/im/m///iim/m//im/m////c//"


def render(out_dir: str) -> list:
    """Write example.tikz (and example.png / example.pdf where matplotlib
    imports) into out_dir; returns the paths written."""
    from ..core.trees import CHA, MSG, ROOT, VARTREE, LUTTree

    os.makedirs(out_dir, exist_ok=True)
    t = LUTTree.from_template(TEMPLATE, VARTREE)
    tikz = t.root.tikz_draw()
    out_tikz = os.path.join(out_dir, "example.tikz")
    with open(out_tikz, "w") as f:
        f.write(tikz + "\n")
    print(f"wrote {out_tikz} ({len(tikz.splitlines())} lines)")
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no example.png / example.pdf")
        return [out_tikz]
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes = []  # (node, depth, x)

    def leaves(n):
        return 1 if not n.children else sum(leaves(c) for c in n.children)

    def place(n, depth, x0):
        w = leaves(n)
        x = x0 + w / 2.0
        nodes.append((n, depth, x))
        cx = x0
        for c in n.children:
            place(c, depth + 1, cx)
            cx += leaves(c)

    place(t.root, 0, 0.0)
    pos = {id(n): (x, -d) for n, d, x in nodes}
    fig, ax = plt.subplots(figsize=(7, 4))
    for n, d, x in nodes:
        for c in n.children:
            cx, cy = pos[id(c)]
            ax.annotate("", xy=(x, -d - 0.08), xytext=(cx, cy + 0.10),
                        arrowprops=dict(arrowstyle="->", lw=0.9, color="0.25"))
    style = {ROOT: (r"$\Phi$", "#c6dbef"), MSG: (r"$\mu$", "#e5f5e0"),
             CHA: (r"$L$", "#fee6ce")}
    for n, d, x in nodes:
        label, fc = style.get(n.type, style[ROOT])
        ax.text(x, -d, label, ha="center", va="center", fontsize=11,
                bbox=dict(boxstyle="circle,pad=0.25", fc=fc, ec="0.3"))
    ax.set_xlim(-0.5, leaves(t.root) + 0.5)
    ax.set_ylim(-t.root.height() - 0.5, 0.5)
    ax.axis("off")
    ax.set_title(f"Variable-node LUT tree, template {TEMPLATE}", fontsize=9)
    written = [out_tikz]
    for ext, kw in (("png", dict(dpi=150)), ("pdf", {})):
        path = os.path.join(out_dir, f"example.{ext}")
        fig.savefig(path, bbox_inches="tight", **kw)
        print(f"wrote {path}")
        written.append(path)
    plt.close(fig)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(RESULTS, "trees"))
    args = ap.parse_args(argv)
    render(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
