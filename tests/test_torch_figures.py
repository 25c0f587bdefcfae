"""The port's figures (`mpnn_tpu_torch.viz`, `python -m
mpnn_tpu_torch.figures`) against `mpnn_tpu.viz`'s, byte for byte:

(a) at full width, from the committed records under results/nets, each
    subcommand writes the files committed under results/figures (which
    `mpnn_tpu.viz` writes there);
(b) from the port's own CLI outputs (a tiny chain run and an adaptive run
    with --stats-log), both packages draw the same bytes;
(c) JAX's topology and label cases (tests/test_viz_train_driver.py).

Each package draws in a process of its own, as its scripts do: the
presentation set changes matplotlib's global style, so it comes last."""

import os
import subprocess
import sys
from types import SimpleNamespace as Ns

import pytest

from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.data.prep import save_archive
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.ops import layers as T
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NETS = os.path.join(REPO, "results", "nets")
FIGURES = os.path.join(REPO, "results", "figures")

# (subcommand, its arguments), in the order one process draws them.
COMMANDS = [("acc-eff", []), ("nlds", ["hybrid-ac", "hybrid-ac-tree"]),
            ("routing-hists", ["hybrid-ac"]),
            ("videos", ["hybrid-ac", "--nets", "0", "--gif"]), ("pres", [])]


def _start_draw(argvs):
    """A fresh process that runs `mpnn_tpu_torch.figures.main` on each
    argv, in order."""
    code = ("from mpnn_tpu_torch.figures import main\n"
            "for argv in %r: main(argv)\n" % (argvs,))
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    # The records and figures are tracked, but .gitignore lists them (the
    # port's chip checks run without them), so a copy of the tree that
    # leaves out ignored files has neither.
    if not (os.path.isdir(os.path.join(NETS, "hybrid-ac", "0000-stats"))
            and os.path.isdir(os.path.join(FIGURES, "pres"))):
        pytest.skip("results/nets' stats and results/figures are not in "
                    "this copy of the tree")
    out = str(tmp_path_factory.mktemp("figures"))
    _finish(_start_draw([[cmd, *args, "--nets-dir", NETS, "--fig-dir", out]
                         for cmd, args in COMMANDS]))
    return out


def _expected(cmd):
    """The committed files a subcommand of COMMANDS writes."""
    names = {
        "acc-eff": ["acc-eff-%s.pdf" % k for k in
                    ("all", "complexity", "strategies", "width")],
        "nlds": ["nld-hybrid-ac.pdf", "nld-hybrid-ac-tree.pdf",
                 "nld-0.pdf", "nld-1.pdf"],
        "routing-hists": ["routing-hists-hybrid-ac.svg"],
        "videos": ["videos/hybrid-ac/0000.gif"] + [
            os.path.join("videos/hybrid-ac/0000", f) for f in
            _files(os.path.join(FIGURES, "videos/hybrid-ac/0000"))],
        "pres": [os.path.join("pres", f)
                 for f in _files(os.path.join(FIGURES, "pres"))]}[cmd]
    return names


@pytest.mark.parametrize("cmd", [c for c, _ in COMMANDS])
def test_full_width_figures_equal_committed(full_width, cmd):
    names = _expected(cmd)
    assert len(names) >= {"videos": 3, "pres": 10}.get(cmd, 1)
    missing = [n for n in names
               if not os.path.exists(os.path.join(full_width, n))]
    assert not missing
    differ = [n for n in names if not _same_bytes(
        os.path.join(full_width, n), os.path.join(FIGURES, n))]
    assert not differ


def test_full_width_writes_nothing_else(full_width):
    """The five subcommands write exactly the files named above."""
    assert _files(full_width) == sorted(
        n for c, _ in COMMANDS for n in _expected(c))


def _tiny_registries():
    def ctor(k_cpt):
        return lambda x0_shape, y_shape: build_chain(
            T, "ac", tuple(x0_shape), y_shape[0], k_cpt=k_cpt)
    # Four nets: the presentation set's routing heatmap draws nets 0-3.
    k_cpts = [0.0, 1e-9, 4e-9, 1.6e-8]
    chain = {"synth-ac": Ns(dataset="data/synth.npz", tau=tcfg.AC_TAU,
                            sweep_k_cpts=k_cpts,
                            nets=[ctor(k) for k in k_cpts])}
    adaptive = {"synth-ac-dynkcpt": Ns(
        dataset="data/synth.npz", tau=tcfg.AC_TAU,
        net=lambda x0_shape, y_shape: build_chain(
            T, "ac", tuple(x0_shape), y_shape[0], dyn_k_cpt=True))}
    return chain, adaptive


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's CLI outputs: the four nets of a tiny synth-ac (3-stage
    chains on 16x16 inputs) to 4 with t_log 2, and a tiny adaptive chain
    to 4 with --stats-log."""
    root = tmp_path_factory.mktemp("port-runs")
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=2)
    save_archive(str(root / "data" / "synth.npz"), arch)
    chain, adaptive = _tiny_registries()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "make_experiments", lambda: chain)
        mp.setattr(tcfg, "make_adaptive_experiments", lambda: adaptive)
        common = ["--n-iter", "4", "--t-log", "2", "--batch-size", "8",
                  "--device", "cpu", "--data-root", str(root),
                  "--out-root", str(root / "nets")]
        ttrain.main(["synth-ac", *common])
        from mpnn_tpu_torch import train_adaptive
        train_adaptive.main(["synth-ac-dynkcpt", "--stats-log", *common])
    return root


JAX_SCRIPTS = {"acc-eff": "make-acc-eff-plots", "nlds": "make-nlds",
               "routing-hists": "make-routing-hists",
               "videos": "make-videos", "pres": "make-pres-figs"}
PORT_COMMANDS = [("acc-eff", []), ("nlds", []),
                 ("routing-hists", ["synth-ac"]),
                 ("videos", ["synth-ac", "--nets", "1", "--gif"]),
                 ("videos", ["synth-ac-dynkcpt", "--nets", "7"]),
                 ("nlds", ["synth-ac-dynkcpt", "--by-class"]),
                 ("pres", ["--auto-lim"])]


def test_port_outputs_draw_as_jax_draws(port_runs):
    """The port's CLI files through the port's figures CLI, and through
    `mpnn_tpu`'s figure scripts (`scripts/make-*`, each one's main, in one
    process in the same order; the two processes run at once): the same
    files, byte for byte."""
    nets = str(port_runs / "nets")
    assert _files(os.path.join(nets, "synth-ac-dynkcpt")).count(
        "0007-stats/00000004.npy") == 1
    port, jax_dir = (str(port_runs / d) for d in ("fig-port", "fig-jax"))
    ours = _start_draw([[cmd, *args, "--nets-dir", nets, "--fig-dir", port]
                        for cmd, args in PORT_COMMANDS])
    code = ("import runpy, sys\n"
            "for script, argv in %r:\n"
            "    sys.argv = [script] + argv\n"
            "    runpy.run_path(script, run_name='__main__')\n"
            % ([(os.path.join(REPO, "scripts", JAX_SCRIPTS[cmd]),
                 [*args, "--nets-dir", nets, "--fig-dir", jax_dir])
                for cmd, args in PORT_COMMANDS],))
    theirs = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    _finish(ours)
    _finish(theirs)
    files = _files(jax_dir)
    assert _files(port) == files
    assert {"acc-eff-all.pdf", "nld-synth-ac.pdf",
            "nld-synth-ac-dynkcpt-by-class.pdf",
            "routing-hists-synth-ac.svg", "videos/synth-ac/0001.gif",
            "videos/synth-ac-dynkcpt/0007/000.png"} <= set(files)
    assert "pres/00.svg" in files
    differ = [f for f in files if not _same_bytes(
        os.path.join(port, f), os.path.join(jax_dir, f))]
    assert not differ


def _leaf_desc(name="LogReg"):
    return {"name": name, "sinks": [],
            "stats_tr": {"p_cor": 0.5, "p_inc": 0.1},
            "stats_ts": {"p_cor": 0.5, "p_inc": 0.1}}


def _node_desc(sinks, name="ReConvMax"):
    return {"name": name, "sinks": sinks, "stats_tr": {}, "stats_ts": {}}


def test_nld_canvas_scales_with_topology(tmp_path):
    """Wide branching trees get wider canvases and wrap into grid rows;
    chains keep compact columns (hand-built descriptors, no training; JAX's
    tests/test_viz_train_driver.py:253)."""
    from mpnn_tpu_torch.viz import nld

    def tree(depth, fan):
        if depth == 0:
            return _leaf_desc()
        return _node_desc([_leaf_desc()] +
                          [tree(depth - 1, fan) for _ in range(fan)])

    chain = {"type": "ActorNet", "root": tree(4, 1),
             "stats_tr": {}, "stats_ts": {}}
    wide = {"type": "ActorNet", "root": tree(4, 2),
            "stats_tr": {}, "stats_ts": {}}
    wc, hc = nld._fig_dims(chain)
    ww, hw = nld._fig_dims(wide)
    assert ww > wc  # 2-way fanout tree is drawn wider than the chain

    # 8 wide trees wrap into multiple rows instead of one microscopic row.
    logs = {"t": [wide] * 8, "c": [chain] * 8}
    p = nld.render_experiment_grid(logs, "t", str(tmp_path / "t.pdf"))
    assert p and os.path.exists(p)
    p = nld.render_experiment_grid(logs, "c", str(tmp_path / "c.pdf"))
    assert p and os.path.exists(p)


def test_cls_labels_pad_past_ten():
    """Legend labels for >10-class descriptors pad with generic names
    instead of failing (JAX's tests/test_viz_train_driver.py:354)."""
    from mpnn_tpu_torch.viz.nld import _cls_label_list, CLS_LABELS

    labels = _cls_label_list(13)
    assert len(labels) == 13
    assert labels[:10] == CLS_LABELS and labels[10:] == [
        "Class 10", "Class 11", "Class 12"]
    assert _cls_label_list(3) == CLS_LABELS[:3]
    assert _cls_label_list(2, ["a", "b"]) == ["a", "b"]


def test_figures_cli_names_missing_matplotlib():
    """Where matplotlib is missing the figures CLI raises an ImportError
    that names it; `import mpnn_tpu_torch.figures` itself needs none."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from mpnn_tpu_torch import figures\n"
            "try:\n"
            "    figures.main(['acc-eff', '--nets-dir', 'none'])\n"
            "except ImportError as e:\n"
            "    print('ImportError:', e)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ImportError:") and "matplotlib" in r.stdout
