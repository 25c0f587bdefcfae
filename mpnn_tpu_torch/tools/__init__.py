"""The repo's campaign and serving tools on the port (counterparts of
`tools/*.py`, module for module, with their names, flags and defaults):

- `serving_frontier`: the measured serving frontier of one adaptive
  (dyn_k_cpt) net, price by price, through the routed engine;
- `dense_crossover`: the all-branches dense forward against calibrated
  routed serving on the wall clock, over the width ladder;
- `retrain_diverged`: the campaign's divergence retry policy;
- `summarize_campaign`: one markdown row per experiment, with outliers;
- `archive_results`: snapshots into `results/`, `--restore`, `--prune`.

Each runs as `python -m mpnn_tpu_torch.tools.<name>`. The ones that touch
a device take `--device` (default cuda) in place of `--platform`."""
