"""The port's counterparts of the repo's example workflows (examples/ at the
repo root), one module each under the same name, each run as
``python -m lut_ldpc_torch.examples.<name>``:

- ``dvbs2_waterfall``: the DVB-S2-scale (N=64800) BER waterfalls;
- ``dvbs2_qc_equivalence``: the two realizations of the DVB-S2 matrix;
- ``ber_waterfall``: the N=1000 (3,6) min-LUT / spa / nms waterfall;
- ``make_assets``: ensembles/, codes/ and trees/ from the port's tools;
- ``render_tree_example``: the example VN tree as TikZ (and PNG / PDF).

The simulating modules run on the card unless ``--device cpu`` is given,
and take a ``channel=`` hook through to ``BERSim``.  Nothing here writes
into the repo's asset folders by default: outputs go under ``results/``.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "results")
