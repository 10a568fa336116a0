"""The train step's CUDA graph (train/reader.py ``_StepGraphs``) on the CPU.

Dropout's keyed masks and its count of applications, the relative-position
buckets kept on the device, the step on CPU tensors (eager, nothing
counted), and a rehearsal of the graphed step with stand-in graphs: the
capture runs the step's Python with the graph's generators handed to the
Dropout modules, a replay runs it again into the captured outputs. The
card's own graphs are tested in tests/test_torch_cuda.py.
"""

import contextlib

import pytest
import torch

from lako_tpu_torch.core import profiling
from lako_tpu_torch.core.config import OptimConfig, T5Config
from lako_tpu_torch.models.t5 import init_fid_t5
from lako_tpu_torch.models.t5.layers import Dropout, RelativePositionBias, _mix, set_dropout_key
from lako_tpu_torch.train import optim, reader
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.reader import make_reader_train_step, model_params
from lako_tpu_torch.train.state import TrainState

TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
            num_heads=4, relative_attention_num_buckets=8, dropout_rate=0.1)


def _model(use_remat=True):
    return init_fid_t5(T5Config(**TINY), torch.Generator().manual_seed(0), use_remat=use_remat)


def _batches(n, N=2, seed=3):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        ids = torch.randint(1, 64, (2, N, 12), generator=gen)
        mask = torch.rand(2, N, 12, generator=gen) < 0.8
        mask[..., 0] = True
        labels = torch.randint(1, 64, (2, 5), generator=gen)
        labels[0, 3:] = -100
        out.append((ids, mask, labels))
    return out


def _graph_counts(t0):
    out = {"train.graph_captures": 0, "train.graph_replays": 0}
    for t, name, n in profiling.snapshot()["counts"]:
        if t >= t0 and name in out:
            out[name] += n
    return out["train.graph_captures"], out["train.graph_replays"]


def _state(model, name="adamw"):
    return TrainState.create(model_params(model), make_optimizer(OptimConfig(
        optim=name, lr=1e-2, warmup_steps=0, total_steps=100, scheduler="linear")))


def test_dropout_mask_is_keyed_by_seed_step_site():
    """A training application keeps ``rand(shape, generator seeded
    _mix(seed, step, site)) < 1 - rate`` scaled by ``1 / (1 - rate)``; each
    application counts, and ``set_dropout_key`` starts the count again;
    generators handed to the module, each seeded alike, give the same mask
    once each; eval mode returns its input."""
    drop = Dropout(0.3)
    drop.site = 5
    x = torch.randn(4, 7, 9)
    with pytest.raises(RuntimeError, match="set_dropout_key"):
        drop(x)
    set_dropout_key(drop, 17, 2)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(_mix(17, 2, 5))) < 0.7
    want = torch.where(keep, x / 0.7, torch.zeros(()))
    assert torch.equal(drop(x), want) and torch.equal(drop(x), want)
    assert drop.applied == 2
    set_dropout_key(drop, 17, 3)
    assert drop.applied == 0 and not torch.equal(drop(x), want)
    set_dropout_key(drop, 17, 2)
    drop.generators = [torch.Generator().manual_seed(_mix(17, 2, 5)) for _ in range(2)]
    assert torch.equal(drop(x), want) and torch.equal(drop(x), want)
    with pytest.raises(IndexError):
        drop(x)
    drop.generators = None
    drop.eval()
    assert drop(x) is x


@pytest.mark.parametrize("use_remat", [True, False])
def test_remat_draws_each_encoder_block_site_twice(use_remat):
    """One training forward and backward: under remat every Dropout of an
    encoder block is applied twice (the forward and the recompute, the same
    mask), every other site once."""
    model = _model(use_remat)
    model.train()
    set_dropout_key(model, 0, 0)
    ids, mask, labels = _batches(1)[0]
    loss = model(ids, mask, labels)[0]
    torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    encoder = {id(m) for block in model.t5.encoder.blocks for m in block.modules()}
    applied = [(m.applied, id(m) in encoder) for m in model.modules() if isinstance(m, Dropout)]
    assert len(applied) == 8 + 2 + 12 + 2
    assert all(n == (2 if use_remat and in_block else 1) for n, in_block in applied)


def test_relpos_buckets_copied_once_a_shape():
    """The bucket ids reach the device once a shape and are the CPU's."""
    relpos = RelativePositionBias(T5Config(**TINY), bidirectional=True, dtype=torch.float32)
    first = relpos.device_buckets(7, 9, 0, torch.device("cpu"))
    assert relpos.device_buckets(7, 9, 0, torch.device("cpu")) is first
    assert torch.equal(first, relpos.buckets(7, 9))
    assert not torch.equal(relpos.device_buckets(7, 9, 2, torch.device("cpu")), first)
    assert len(relpos._on_device) == 2


def test_cpu_step_stays_eager():
    """On CPU tensors the step is the eager one whatever ``cuda_graphs``
    says: the same losses and parameters after 3 steps with dropout and
    remat, and no graph counted."""
    runs = []
    t0 = profiling.now()
    for graphs in (True, False):
        model = _model()
        state = _state(model)
        step = make_reader_train_step(model, cuda_graphs=graphs)
        losses = []
        for batch in _batches(3):
            state, loss = step(state, *batch, 9)
            losses.append(loss)
        runs.append((losses, {k: p.detach().clone() for k, p in state.params.items()}))
    assert _graph_counts(t0) == (0, 0)
    (got_l, got_p), (want_l, want_p) = runs
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)


class _StandInGraph:
    """A CUDA graph's stand-in. Capturing the forward and backward runs its
    Python (with the graph's generators handed to the Dropout modules) and
    keeps the outputs; capturing the update only keeps its arguments. A
    replay runs the step again into the kept outputs, or the update's device
    half (``tx.apply``, reading the values ``tx.load`` wrote)."""

    capturing = None
    pools = []      # the pool each capture was handed

    def __init__(self):
        self.generators = []
        self.step = None
        self.update = None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def pool(self):
        return "pool"

    def replay(self):
        if self.update is not None:
            _eager_apply_update(*self.update)
            return
        model, params, inputs, dropout, loss, grads = self.step
        for module, generators in dropout:
            module.generators, module.applied = generators, 0
        try:
            got, got_grads = _eager_forward_backward(model, params, *inputs)
        finally:
            for module, _ in dropout:
                module.generators = None
        with torch.no_grad():
            loss.copy_(got)
            for mine, new in zip(grads, got_grads):
                mine.copy_(new)


_eager_forward_backward = reader._forward_backward
_eager_apply_update = reader._apply_update


def _capturing_forward_backward(model, params, ids, mask, labels):
    loss, grads = _eager_forward_backward(model, params, ids, mask, labels)
    graph = _StandInGraph.capturing
    if graph is not None:
        dropout = [(m, m.generators) for m in model.modules()
                   if isinstance(m, Dropout) and m.generators is not None]
        assert [g for _, gens in dropout for g in gens] == graph.generators
        graph.step = (model, params, (ids, mask, labels), dropout, loss.detach(), grads)
    return loss, grads


def _capturing_apply_update(tx, opt_state, params, grads):
    graph = _StandInGraph.capturing
    assert graph is not None, "the update runs only inside the graph"
    graph.update = (tx, opt_state, params, grads)


@contextlib.contextmanager
def _stand_in_capture(graph, pool=None, stream=None):
    _StandInGraph.capturing = graph
    _StandInGraph.pools.append(pool)
    try:
        yield
    finally:
        _StandInGraph.capturing = None


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """:class:`reader._StepGraphs` on CPU tensors with stand-in graphs, and
    Adafactor's card route (K7's plain version) on CPU tensors."""
    monkeypatch.setattr(optim, "_on_card", lambda t: True)
    monkeypatch.setattr(reader, "_forward_backward", _capturing_forward_backward)
    monkeypatch.setattr(reader, "_apply_update", _capturing_apply_update)
    monkeypatch.setattr(reader._StepGraphs, "_side_stream", lambda self, device: None)
    monkeypatch.setattr(reader._StepGraphs, "_side_forward_backward",
                        lambda self, params, *batch: reader._forward_backward(self.model,
                                                                              params, *batch))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(_StandInGraph, "pools", [])


def _run(calls, graphed, dtype=torch.float32):
    """The calls' losses, the parameters and Adafactor's statistics after
    them and the graph counters after each call, driving
    :class:`reader._StepGraphs` as ``make_reader_train_step`` does on the
    card (``graphed``) or the eager step; a call "rebind" gives every
    parameter a new buffer."""
    model = _model().to(dtype)
    state = _state(model, "adafactor")
    graphs = reader._StepGraphs(model) if graphed else None
    t0, losses, counts = profiling.now(), [], []
    for batch in calls:
        if batch == "rebind":
            for p in model.parameters():
                p.data = p.data.clone()
            continue
        model.train()
        set_dropout_key(model, 13, state.step)
        out = graphs(state, *batch, 13) if graphs is not None else None
        state, loss = out if out is not None else reader._eager_step(model, state, *batch)
        losses.append(loss)
        counts.append(_graph_counts(t0))
    fact = state.opt_state[1].factored_rms
    kept = {k: p.detach().clone() for k, p in state.params.items()}
    kept.update({(name, k): t.clone() for name in ("v_row", "v_col", "v")
                 for k, t in getattr(fact, name).items()})
    assert state.step == fact.count == len(losses)
    return losses, kept, counts


def test_stand_in_graphs_replay_the_eager_step(stand_in_graphs):
    """The graphed path's bookkeeping: one eager first step a shape, one
    capture of the forward and backward (a generator for each dropout
    application, the remat recompute included) and of the update, a replay
    of both a later call with the generators seeded from ``(seed, step,
    site)`` and the update's values loaded for the step; a second shape
    captures once more, the first replays again, and a rebound parameter
    makes each shape capture again (a new pool when its graphs were the
    only ones). Losses, parameters and the optimizer's statistics are the
    eager step's bitwise, each loss a tensor of its own."""
    a, b = _batches(3), _batches(2, N=3, seed=4)
    calls = [a[0], a[1], "rebind", a[2], b[0], b[1], a[0], "rebind", a[1], b[0]]
    got_l, got_p, counts = _run(calls, graphed=True)
    assert counts == [(0, 0), (1, 1), (2, 2), (2, 2), (3, 3), (3, 4), (4, 5), (5, 6)]
    assert _StandInGraph.pools == [None, "pool", None, "pool"] + ["pool"] * 6
    want_l, want_p, none = _run(calls, graphed=False)
    assert none == [(0, 0)] * 8
    assert all(torch.equal(x, y) for x, y in zip(got_l, want_l))
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    assert len({id(loss) for loss in got_l}) == len({loss.data_ptr() for loss in got_l}) == 8


def test_stand_in_graphs_keep_a_few_shapes(stand_in_graphs, monkeypatch):
    """Past ``GRAPH_SHAPES`` shapes the oldest graphs go; their shape, run
    once already, captures again at its next call without an eager step,
    as every shape does after ``release``."""
    monkeypatch.setattr(reader, "GRAPH_SHAPES", 1)
    a, b = _batches(2), _batches(2, N=3, seed=4)
    calls = [a[0], a[1], b[0], b[1], a[0], a[1]]
    got_l, got_p, counts = _run(calls, graphed=True)
    assert counts == [(0, 0), (1, 1), (1, 1), (2, 2), (3, 3), (3, 4)]
    want_l, want_p, _ = _run(calls, graphed=False)
    assert all(torch.equal(x, y) for x, y in zip(got_l, want_l))
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    graphs = reader._StepGraphs(_model())
    graphs.graphs, graphs.pool = {"shape": None}, "pool"
    graphs.release()
    assert graphs.graphs == {} and graphs.pool is None


def test_stand_in_graphs_leave_an_update_they_cannot_capture(stand_in_graphs):
    """Adafactor on bfloat16 masters takes the eager chain, which no graph
    captures (``TrainState.load_update`` gives None): after its first step
    a shape runs eagerly, with nothing captured and the eager step's
    results."""
    calls = _batches(3)
    got_l, got_p, counts = _run(calls, graphed=True, dtype=torch.bfloat16)
    assert counts == [(0, 0)] * 3 and _StandInGraph.pools == []
    want_l, want_p, _ = _run(calls, graphed=False, dtype=torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(got_l, want_l))
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
