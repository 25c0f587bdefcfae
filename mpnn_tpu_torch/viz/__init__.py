"""The figures (counterpart of `mpnn_tpu/viz/`, module for module): stats
loading, accuracy-vs-ops curves, node-link diagrams and video frames,
routing histograms and the presentation set, from the descriptor files
the trainers write. Host-side: numpy, matplotlib, seaborn and, for GIFs,
PIL; no torch. Nothing else of the package imports it, so training and
serving run where matplotlib is absent. The entry point is
`python -m mpnn_tpu_torch.figures`."""

import os

# Reproducible figure bytes: matplotlib stamps PDFs with /CreationDate and
# SVGs with dc:date and per-run hashed element ids. SOURCE_DATE_EPOCH pins
# both date stamps; svg.hashsalt pins the SVG id hashes. Set before pyplot
# state is touched by the submodules below; respects an externally
# provided epoch. The values are `mpnn_tpu.viz`'s, so both packages write
# the same bytes.
os.environ.setdefault("SOURCE_DATE_EPOCH", "315532800")  # 1980-01-01

import matplotlib  # noqa: E402

matplotlib.use("Agg")
matplotlib.rcParams["svg.hashsalt"] = "mpnn-tpu"

from . import loading, acc_eff, nld, routing  # noqa: E402

__all__ = ["loading", "acc_eff", "nld", "routing"]
