"""The train step's CUDA-graph path, as far as it runs without a card:
the confusion matrix that reads nothing back to the host, the conditions
under which a step may replay a graph, the choice between capture, replay
and eager steps, and the capturable Adam with its checkpoints. The graph
itself runs in ``tests/test_torch_cuda.py``."""

import contextlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from satellite_computervision_tpu_torch.models import UNet, losses, metrics
from satellite_computervision_tpu_torch.train import trainer
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager


def _bincount_cm(y_true, y_pred, n):
    """The confusion matrix as ``torch.bincount`` gave it: the reference."""
    flat = y_true.reshape(-1).long() * n + y_pred.reshape(-1).long()
    return torch.bincount(flat, minlength=n * n)[: n * n].reshape(n, n).float()


def _cm_case(case):
    g = torch.Generator().manual_seed(hash(case) % 1000)
    if case.startswith("random"):
        n = int(case.split("_")[1])
        shape = (4, 33, 17)
        return torch.randint(0, n, shape, generator=g), torch.randint(0, n, shape, generator=g), n
    if case == "one_hot":  # the trainer's labels: argmax of one-hot, against a thresholded head
        labels = torch.nn.functional.one_hot(torch.randint(0, 3, (2, 9, 9), generator=g), 3)
        return torch.argmax(labels, -1), torch.randint(0, 3, (2, 9, 9), generator=g), 3
    if case == "binary_bool":
        return torch.rand(3, 8, 8, generator=g) > 0.5, torch.rand(3, 8, 8, generator=g) > 0.3, 2
    if case == "empty":
        return torch.zeros(0, dtype=torch.long), torch.zeros(0, dtype=torch.long), 2
    if case == "beyond_bins":  # true * n + pred at or above n², dropped as bincount's cut drops it
        return torch.tensor([0, 1, 1, 2, 2, 3]), torch.tensor([1, 0, 1, 0, 2, 1]), 2
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random_2", "random_3", "random_8", "one_hot", "binary_bool",
                                  "empty", "beyond_bins"])
def test_confusion_matrix_counts_as_bincount(case):
    y_true, y_pred, n = _cm_case(case)
    got = metrics.confusion_matrix(y_true, y_pred, n)
    want = _bincount_cm(y_true, y_pred, n)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert torch.equal(got, want)
    if case == "beyond_bins":
        assert got.sum() == 3  # (2, 0), (2, 2) and (3, 1) are past the 2 x 2 bins


class _StubGraph:
    """Stands in for ``trainer._StepGraph``, which needs a card: records
    that a capture was asked for."""

    def __init__(self, state, batch):
        self.out = None

    def current(self):
        return True


def _fake_cuda_batch(batch=2, side=8):
    """Tensors that say they live on CUDA, made without a card."""
    with FakeTensorMode():
        return (torch.empty((batch, side, side, 6), device="cuda"),
                torch.empty((batch, side, side, 1), device="cuda"))


def _tiny_state(capturable=True):
    torch.manual_seed(0)
    model = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=capturable)
    return trainer.TrainState(model=model, optimizer=opt)


@pytest.mark.parametrize("case", ["graphed", "cpu_tensor", "flop_counter", "data_parallel",
                                  "not_capturable", "seen_once"])
def test_which_steps_may_replay_a_graph(case, monkeypatch):
    """Three steps of one signature: two eager, then the capture. Every
    case but the first keeps the third step eager: CPU inputs, a step
    under ``FlopCounterMode`` (the benchmark counts FLOPs so), a
    data-parallel wrapper, an optimizer that cannot be captured, and a
    signature seen once (after two steps of another)."""
    monkeypatch.setattr(trainer, "_StepGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    state = _tiny_state(capturable=case != "not_capturable")
    if case == "data_parallel":
        state.model = torch.nn.DataParallel(state.model)
    if case == "cpu_tensor":
        batches = [(torch.zeros(2, 8, 8, 6), torch.zeros(2, 8, 8, 1))] * 3
    else:
        batches = [_fake_cuda_batch()] * 2 + [_fake_cuda_batch(batch=1 if case == "seen_once" else 2)]
    cache = trainer._GraphCache()
    with FlopCounterMode(display=False) if case == "flop_counter" else contextlib.nullcontext():
        chosen = [cache.lookup(state, b) for b in batches]
    assert chosen[:2] == [None, None]
    assert isinstance(chosen[2], _StubGraph) == (case == "graphed")
    if case == "graphed":  # captured: the signature replays from now on
        assert cache.lookup(state, batches[0]) is chosen[2]
        cache.failed(state, batches[0])
        assert cache.lookup(state, batches[0]) is None


def test_a_failed_capture_keeps_its_signature_eager(monkeypatch):
    """A signature whose capture failed is not tried again; another one
    still counts its steps toward a capture, and a graph whose state has
    moved is dropped and its signature warmed up again."""
    monkeypatch.setattr(trainer, "_StepGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    state, a, b = _tiny_state(), _fake_cuda_batch(), _fake_cuda_batch(batch=3)
    cache = trainer._GraphCache()
    assert [cache.lookup(state, a) for _ in range(3)][2] is not None
    cache.failed(state, a)
    assert all(cache.lookup(state, a) is None for _ in range(4))
    got = [cache.lookup(state, b) for _ in range(3)]
    assert got[:2] == [None, None] and got[2] is not None
    monkeypatch.setattr(_StubGraph, "current", lambda self: False)
    again = [cache.lookup(state, b) for _ in range(3)]
    assert again[:2] == [None, None] and again[2] not in (None, got[2])


def test_step_counts_and_spans_through_a_stub_graph(monkeypatch):
    """The step function's bookkeeping with the graph stood in for by
    eager runs: two eager steps, a capture that counts as the first
    replay, then replays; ``train.step`` carries ``graphed``; the state's
    step count moves once a step either way."""
    from torch.profiler import ProfilerActivity, profile

    from satellite_computervision_tpu_torch.utils.profiling import span_log

    class EagerGraph(_StubGraph):
        def capture(self, run, state):
            self.run, self.state, self.out = run, state, {}
            return True

        def replay(self, batch):
            return self.run(self.state, batch)

    monkeypatch.setattr(trainer, "_StepGraph", EagerGraph)
    monkeypatch.setattr(trainer, "_graphable", lambda state, batch: True)
    state = _tiny_state(capturable=False)  # a capturable Adam steps on CUDA only
    step = trainer.make_train_step(lambda y, p: losses.weighted_bce(y, p, 2.0, logits=True))
    g = torch.Generator().manual_seed(1)
    batch = (torch.randn(2, 8, 8, 6, generator=g), (torch.rand(2, 8, 8, 1, generator=g) > 0.5).float())
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [step(state, batch) for _ in range(5)]
    assert (step.captures, step.replays, step.eager) == (1, 3, 2) and state.step == 5
    assert all(o["cm"].sum() == 2 * 8 * 8 for o in outs)
    steps = [s.attrs for s in span_log() if s.name == "train.step"]
    assert [a["graphed"] for a in steps] == [False, False, True, True, True]
    assert [a["step"] for a in steps] == list(range(5))


def test_create_train_state_adam_is_capturable_only_on_cuda(monkeypatch):
    """CPU parameters get optax's Adam as before; parameters on CUDA the
    same settings, ``capturable`` and ``fused`` (the device check stood in
    for)."""
    model = _tiny_state().model
    cpu = trainer.create_train_state(model).optimizer.param_groups[0]
    assert not cpu["capturable"]
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    card = trainer.create_train_state(model).optimizer.param_groups[0]
    monkeypatch.undo()
    assert card["capturable"] and card["fused"] and not cpu["fused"]
    settings = lambda g: {k: v for k, v in g.items()  # noqa: E731
                          if k not in ("params", "capturable", "fused")}
    assert settings(card) == settings(cpu)
    assert (cpu["lr"], cpu["betas"], cpu["eps"], cpu["weight_decay"]) == (9e-4, (0.9, 0.999), 1e-8, 0)


def test_old_optimizer_checkpoint_loads_into_a_capturable_adam(tmp_path):
    """A checkpoint written by a non-capturable Adam restores into a
    capturable one: the moments and step counts load, and the optimizer
    stays capturable (``load_state_dict`` alone would take the writer's
    flag); the other way round it stays non-capturable. (The ``dcp``
    backend steps an empty optimizer to build its state, which a
    capturable Adam does only on the card: ``tests/test_torch_cuda.py``.)"""
    backend = "pt"
    old = _tiny_state(capturable=False)
    old.model(torch.randn(2, 8, 8, 6))["logits"].sum().backward()
    old.optimizer.step()
    manager = CheckpointManager(str(tmp_path), backend=backend)
    manager.save(old, step=1)
    new = _tiny_state(capturable=True)
    manager.restore(new)
    assert all(g["capturable"] for g in new.optimizer.param_groups)
    for p, q in zip(new.model.parameters(), old.model.parameters()):
        got, want = new.optimizer.state[p], old.optimizer.state[q]
        assert float(got["step"]) == float(want["step"]) == 1.0
        assert torch.equal(got["exp_avg"], want["exp_avg"])
        assert torch.equal(got["exp_avg_sq"], want["exp_avg_sq"])
    back = _tiny_state(capturable=False)
    CheckpointManager(str(tmp_path / "back"), backend=backend).save(new, step=1)
    CheckpointManager(str(tmp_path / "back"), backend=backend).restore(back)
    assert not any(g["capturable"] for g in back.optimizer.param_groups)
