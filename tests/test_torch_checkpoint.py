"""The port's run loop: checkpoints, resume, preemption, profiling and
cross-process metrics (CPU).

Checkpoint round trips of the optimizer states bitwise, and a template that
does not match raising; ``train_reader`` with checkpoints, a full resume
(``reset_params=False``) and a warm start (``reset_params=True``) against the
JAX function from the same flax init (the JAX side on its 8-device CPU mesh
at batch 1 a device, the port on one device at batch 8: the same batches);
the preemption save and exit, the signal handlers and the requeue command;
the profiler window, ``start_trace`` and the spans it mirrors;
``weighted_average`` over two gloo processes.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.train.reader import train_reader as jax_train_reader
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.core import preemption, profiling
from lako_tpu_torch.core.checkpoint import flatten_tree, load_checkpoint, save_checkpoint
from lako_tpu_torch.models.t5 import FiDT5, jax_param_paths, params_from_jax
from lako_tpu_torch.train import optim8
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.reader import train_reader
from tests.fixtures import make_examples, make_tokenizer
from tests.test_torch_train import _fixture_config, _port_tokenizer

REPO = Path(__file__).resolve().parents[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"t5/encoder/block_0/self_attn/q/kernel": torch.randn(48, 40, generator=g),
            "t5/encoder/final_ln/weight": torch.randn(40, generator=g),
            "t5/shared/embedding": torch.randn(300, 40, generator=g)}


def _assert_same(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert type(v) is type(fb[k]) and v == fb[k], k


@pytest.mark.parametrize("optim_name,accum", [("adamw", 1), ("adamw8bit", 1), ("adamw", 2),
                                             ("adafactor", 1)])
def test_optimizer_state_round_trip(tmp_path, optim_name, accum):
    """Save after two updates, load into a fresh template: every tensor and
    count bitwise, the same structure (NamedTuples, FlatMoments with their
    rows), and the next update from the loaded state bitwise the next update
    from the saved one."""
    params = _tree()
    tx = make_optimizer(port_config.OptimConfig(optim=optim_name, warmup_steps=1,
                                                total_steps=10, accumulation_steps=accum))
    state = tx.init(params)
    for seed in (1, 2):
        updates, state = tx.update(_tree(seed), state, params)
    path = save_checkpoint(str(tmp_path), "step2", params, state, step=2, best_eval_metric=0.5,
                           extra={"epoch": 1})
    loaded_params, loaded, meta = load_checkpoint(str(tmp_path), _tree(9), tx.init(_tree(9)))
    assert meta == {"step": 2, "best_eval_metric": 0.5, "epoch": 1}
    assert Path(path) == (tmp_path / "checkpoint" / "latest").resolve()
    _assert_same(loaded_params, params)
    _assert_same(loaded, state)
    assert type(loaded) is type(state)
    if optim_name == "adamw8bit":
        mu = loaded[1].mu
        assert isinstance(mu, optim8.FlatMoments) and mu.rows == state[1].mu.rows
    _assert_same(tx.update(_tree(3), loaded, params), tx.update(_tree(3), state, params))


def test_mismatched_template_raises(tmp_path):
    params = _tree()
    tx = make_optimizer(port_config.OptimConfig(optim="adamw8bit"))
    save_checkpoint(str(tmp_path), "x", params, tx.init(params))
    path = str(tmp_path / "checkpoint" / "x")
    wrong_shape = dict(params, **{"t5/encoder/final_ln/weight": torch.zeros(41)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, wrong_shape)
    with pytest.raises(ValueError, match="no entry"):
        load_checkpoint(path, dict(params, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="does not hold"):
        load_checkpoint(path, {k: v for k, v in params.items() if "embedding" not in k})
    clip, adam, lr_count, decay_count = tx.init(params)
    with pytest.raises(ValueError, match="the template a tensor"):
        load_checkpoint(path, params, (clip, adam, torch.zeros(()), decay_count))
    with pytest.raises(ValueError, match="the template a number"):
        load_checkpoint(path, params, (clip, adam._replace(mu={"q": 0, "scale": adam.mu.scale}),
                                       lr_count, decay_count))
    other = dict(params, **{"t5/decoder/x/kernel": torch.zeros(256, 2)})
    with pytest.raises(ValueError):
        load_checkpoint(path, params, tx.init(other))


def _resume_configs(cfg_module, tmp_path, side):
    cfg, t5 = _fixture_config(cfg_module)
    batch = 8 if cfg_module is port_config else 1
    cfg = cfg.replace(per_device_batch_size=batch, epochs=3, eval_max_length=4, use_remat=False,
                      checkpoint_dir=str(tmp_path / side), name="first",
                      optim=cfg.optim.replace(scheduler_steps=100))
    return cfg, t5.replace(use_flash_attention=False)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Each package: 3 epochs with checkpoints from one flax init, then one
    epoch resumed from its last save with the optimizer (full) and without
    (warm)."""
    tmp = tmp_path_factory.mktemp("resume")
    jcfg, jt5 = _resume_configs(jax_config, tmp, "jax")
    cfg, t5 = _resume_configs(port_config, tmp, "port")
    jm = JaxFiDT5(jt5, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(4), np.zeros((2, 2, 20), np.int32),
                     np.ones((2, 2, 20), bool), np.zeros((2, 4), np.int32))["params"]
    init = params_from_jax(params)   # before the JAX run, which donates its buffers
    train, evals = make_examples(16, n_facts=2), make_examples(8, n_facts=2, seed=9)
    out = {"jax": {}, "port": {}}
    jtok, tok = make_tokenizer(), _port_tokenizer()
    out["jax"]["first"] = jax_train_reader(jcfg, train, evals, jtok, init_params=params,
                                           t5_config=jt5)
    out["port"]["first"] = train_reader(cfg, train, evals, tok, init_params=init, t5_config=t5,
                                        device="cpu")
    for name, reset in (("full", False), ("warm", True)):
        out["jax"][name] = jax_train_reader(
            jcfg.replace(epochs=1, name=name), train, evals, jtok, t5_config=jt5,
            resume_from=str(tmp / "jax" / "first"), reset_params=reset)
        out["port"][name] = train_reader(
            cfg.replace(epochs=1, name=name), train, evals, tok, t5_config=t5,
            resume_from=str(tmp / "port" / "first"), reset_params=reset, device="cpu")
    out["dirs"] = {"jax": tmp / "jax", "port": tmp / "port"}
    return out


@pytest.mark.parametrize("run,steps", [("first", 6), ("full", 8), ("warm", 2)])
def test_train_reader_resume_matches_jax(resumed, run, steps):
    """final_step, best_dev_em and each epoch's EM equal, the losses within
    rtol 1e-5, and the meta of the run's last save equal."""
    j, p = resumed["jax"][run], resumed["port"][run]
    assert p.final_step == j.final_step == steps
    assert p.state.step == steps
    assert p.best_dev_em == j.best_dev_em
    assert [h["em"] for h in p.history] == [h["em"] for h in j.history]
    np.testing.assert_allclose([h["loss"] for h in p.history], [h["loss"] for h in j.history],
                               rtol=1e-5)
    metas = [json.loads((resumed["dirs"][s] / run / "checkpoint" / "last" / "meta.json")
                        .read_text()) for s in ("jax", "port")]
    assert metas[0] == metas[1]
    assert metas[1]["step"] == steps
    saves = [sorted(x.name for x in (resumed["dirs"][s] / run / "checkpoint").iterdir())
             for s in ("jax", "port")]
    assert saves[0] == saves[1]


def test_adamw8bit_checkpoint_and_resume(tmp_path):
    """The 8-bit run's ``last`` save holds the trained state bitwise (the
    flat codes and scales included); a full resume restores the optimizer
    (its count goes on from the saved step), a warm start does not."""
    cfg, t5 = _fixture_config(port_config)
    cfg = cfg.replace(epochs=1, checkpoint_dir=str(tmp_path), name="first",
                      optim=cfg.optim.replace(optim="adamw8bit"))
    train, evals, tok = make_examples(8, n_facts=2), make_examples(2, n_facts=2), _port_tokenizer()
    first = train_reader(cfg, train, evals, tok, t5_config=t5, device="cpu")
    template = FiDT5(t5)
    params, opt, meta = load_checkpoint(str(tmp_path / "first"), template.state_dict(),
                                        first.state.opt_state)
    paths = jax_param_paths(template)
    _assert_same({paths[k]: v for k, v in params.items()}, first.state.params)
    _assert_same(opt, first.state.opt_state)
    assert meta == {"step": 2, "best_eval_metric": first.best_dev_em}
    for name, reset, count in (("full", False, 4), ("warm", True, 2)):
        run = train_reader(cfg.replace(name=name), train, evals, tok, t5_config=t5,
                           resume_from=str(tmp_path / "first"), reset_params=reset,
                           device="cpu")
        assert run.final_step == count and run.state.opt_state[1].count == count


def test_preemption_saves_and_exits(tmp_path, monkeypatch):
    """With the flag up, the first step is followed by a ``preempted`` save
    (params, optimizer, step 1) and ``sys.exit(0)``."""
    cfg, t5 = _fixture_config(port_config)
    cfg = cfg.replace(checkpoint_dir=str(tmp_path), name="pre")
    monkeypatch.setattr(preemption, "_PREEMPTED", True)
    with pytest.raises(SystemExit) as exc:
        train_reader(cfg, make_examples(8, n_facts=2), make_examples(2, n_facts=2),
                     _port_tokenizer(), t5_config=t5, device="cpu")
    assert exc.value.code == 0
    saved = tmp_path / "pre" / "checkpoint" / "preempted"
    assert sorted(x.name for x in saved.iterdir()) == ["meta.json", "opt_state.pt", "params.pt"]
    assert json.loads((saved / "meta.json").read_text()) == {"step": 1, "best_eval_metric": 0.0}


def test_signal_handlers_and_requeue(monkeypatch):
    """SIGUSR1 raises the flag (SIGTERM ignored unless trapped); under SLURM
    the main process requeues its job."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGUSR1, signal.SIGTERM)}
    try:
        preemption.install_handlers()
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_IGN
        os.kill(os.getpid(), signal.SIGUSR1)
        assert preemption.preempted()
    finally:
        preemption.reset()
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    assert not preemption.preempted()
    monkeypatch.setenv("SLURM_JOB_ID", "42")
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert preemption.requeue_command() == ["scontrol", "requeue", "42"]
    monkeypatch.setenv("SLURM_PROCID", "1")
    assert preemption.requeue_command() is None


def test_trace_context_and_step_timer(tmp_path):
    """start_trace writes one Chrome trace holding the program's spans,
    mirrored as ranges of their names around their operators, each flagged
    as profiled; a span's start on the profiler's clock lies within 1 ms of
    its range's. Spans after the trace are not flagged."""
    stop = profiling.start_trace(str(tmp_path))
    with profiling.span("warm"):              # the process's first range sets up
        pass
    with profiling.span("step.outer") as outer:
        with profiling.span("step.inner") as inner:
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = stop()
    with profiling.span("step.after") as after:
        pass
    assert [p.name for p in tmp_path.iterdir()] == [Path(path).name]
    trace = json.loads(Path(path).read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = {e["name"]: e for e in trace["traceEvents"] if e.get("name", "").startswith("step.")}
    assert {"step.outer", "step.inner"} == set(ranges)
    assert "aten::mm" in {e.get("name") for e in trace["traceEvents"]}
    for span in (outer, inner):
        start_ns = ranges[span.name]["ts"] * 1e3 + base
        assert abs(profiling.profiler_ns(span.start_ns) - start_ns) < 1e6
        assert span.profiled
    assert inner.parent == outer.sid and not after.profiled


@pytest.mark.parametrize("epochs,batch", [(3, 8), (1, 4)])
def test_profile_window_writes_a_trace(tmp_path, epochs, batch):
    """profile_dir traces this process's steps 3-5; a run that ends first
    (4 steps) closes the trace at its end. Either way one Chrome trace of
    the train steps' operators, named by the step's spans, lands in
    profile_dir."""
    cfg, t5 = _fixture_config(port_config)
    cfg = cfg.replace(epochs=epochs, profile_dir=str(tmp_path / "prof"),
                      per_device_batch_size=batch)
    train_reader(cfg, make_examples(16, n_facts=2), make_examples(2, n_facts=2),
                 _port_tokenizer(), t5_config=t5, save_checkpoints=False, device="cpu")
    traces = list((tmp_path / "prof").iterdir())
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert {"train.fwd_bwd", "train.optimizer"} <= {e.get("name") for e in events}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_weighted_average_over_two_processes():
    """Two gloo processes: the count-weighted mean and the plain mean that
    every process gets back, and is_main on rank 0 only."""
    code = ("import json, torch.distributed as dist; "
            "from lako_tpu_torch.core import distributed as d; "
            "d.initialize(device='cpu'); r = dist.get_rank(); "
            "print(json.dumps([d.weighted_average([0.5, 0.25][r], [4, 12][r]), "
            "d.average_main([1.0, 3.0][r]), d.is_main(), d.process_count()])); "
            "dist.destroy_process_group()")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    results = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for rank, (wavg, mean, main, count) in enumerate(results):
        assert wavg == [pytest.approx(0.3125), 16]
        assert mean == 2.0 and main == (rank == 0) and count == 2
