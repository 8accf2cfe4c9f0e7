"""The port's training loop against heal_tpu's: the input stream, the
prefetch pipeline and resume, on entry_tiny, on the CPU.

Both CLIs (``heal_tpu.tools.train.main`` and
``heal_tpu_torch.tools.train.main``) run with their ``Trainer`` replaced by
a recorder, so each test sees exactly which batch every train step got, in
which order, and which learning rate; the synthetic backend gets a
``reinitialize`` that records its seeds. Batches are told apart by their
poses and GT boxes, which both host sides assemble bit for bit alike.
"""
import copy
import hashlib
import os

import numpy as np
import pytest
import torch

import heal_tpu.data.synthetic as jax_synthetic
import heal_tpu.tools.train as jax_train
from heal_tpu.parallel.schedulers import build_lr_schedule as jax_schedule
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu_torch.config import load_yaml, save_yaml
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.data import synthetic as port_synthetic
from heal_tpu_torch.data.prefetch import prefetch
from heal_tpu_torch.parallel import Trainer, pin, to_device
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train as train_tool

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"


def _tag(batch) -> str:
    return hashlib.sha1(b"".join(
        np.asarray(batch[k]).tobytes()
        for k in ("pairwise_affine", "gt_boxes"))).hexdigest()


class _JaxState:
    params: dict = {}
    batch_stats: dict = {}

    def replace(self, **kw):
        return self


class _JaxRecorder:
    """Stands in for heal_tpu.parallel.Trainer in JAX's CLI."""

    def __init__(self, seen, **kw):
        self.seen = seen

    def init_state(self, rng, example):
        return _JaxState()

    def compile(self):
        pass

    def shard_state(self, state):
        return state

    def shard_batch(self, batch):
        return batch

    def train_step(self, state, batch):
        self.seen.append(_tag(batch))
        return state, {"total_loss": np.float32(0.0)}

    def eval_step(self, state, batch):
        return {"total_loss": np.float32(0.0)}


class _PortRecorder:
    """Stands in for the port's Trainer in its CLI."""

    def __init__(self, seen):
        self.seen = seen
        self.model = torch.nn.Linear(1, 1)

    def train_step(self, batch):
        self.seen.append(_tag(batch))
        return {"total_loss": torch.zeros(())}

    def eval_step(self, batch):
        return {"total_loss": torch.zeros(())}


def _tiny_cfg(tmp_path, **train_params) -> str:
    cfg = load_yaml(TINY)
    cfg["train_params"].update(train_params)
    path = str(tmp_path / "tiny.yaml")
    save_yaml(cfg, path)
    return path


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "streamed"])
def test_epoch_batch_order_matches_jax(cache, tmp_path, monkeypatch):
    """Two epochs of entry_tiny: the port's train steps get the batches
    JAX's get, in JAX's order. With ``cache_device_batches`` that is the
    unshuffled batches permuted by ``default_rng(epoch)``, and the backend
    is never reinitialised; without it, the seeded sample shuffle behind
    ``reinitialize(seed=epoch)`` and the prefetch pipeline."""
    yaml = _tiny_cfg(tmp_path, cache_device_batches=cache, epoches=2)
    seeds = {"jax": [], "port": []}
    for mod, side in ((jax_synthetic, "jax"), (port_synthetic, "port")):
        monkeypatch.setattr(
            mod.SyntheticDataset, "reinitialize",
            lambda self, seed=0, side=side: seeds[side].append(
                (self.train, seed)),
            raising=False)

    jax_seen, port_seen = [], []
    monkeypatch.setattr(jax_train, "Trainer",
                        lambda **kw: _JaxRecorder(jax_seen, **kw))
    jax_train.main(["-y", yaml, "--model_dir", str(tmp_path / "jax"),
                    "--no_final_inference"])
    monkeypatch.setattr(train_tool, "build_trainer",
                        lambda *a, **kw: _PortRecorder(port_seen))
    train_tool.main(["-y", yaml, "--model_dir", str(tmp_path / "port"),
                     "--no_final_inference", "--device", "cpu"])

    steps = len(build_dataset(load_yaml(yaml)).backend) // 2
    assert len(port_seen) == 2 * steps and port_seen == jax_seen
    if cache:  # the same batches, twice
        assert len(set(port_seen)) == steps
    assert port_seen[:steps] != port_seen[steps:]  # reshuffled per epoch
    assert seeds["port"] == seeds["jax"] == (
        [] if cache else [(True, 0), (True, 1)])


def test_prefetched_batches_equal_serial_ones():
    """The pipeline's batches (assembled and pinned in the worker, copied
    by the consumer) are the serial ones, key for key and bit for bit,
    and in order."""
    ds = build_dataset(load_yaml(TINY), train=False)
    serial = [to_device(b, "cpu") for b in ds.batches(2, shuffle=True,
                                                      seed=5)]
    piped = [to_device(b, "cpu") for b in prefetch(
        ds.batches(2, shuffle=True, seed=5), lambda b: pin(b, "cpu"),
        depth=3)]
    assert len(piped) == len(serial) == 2

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

    for a, b in zip(piped, serial):
        same(a, b)
    # collate's aliases stay one tensor through pin and to_device
    assert piped[0]["points"] is piped[0]["inputs_m1"]["points"]


def test_prefetch_reraises_a_worker_exception():
    class Broken(RuntimeError):
        pass

    def batches():
        yield 1
        yield 2
        raise Broken("assembly failed")

    got = []
    with pytest.raises(Broken, match="assembly failed"):
        for b in prefetch(batches(), lambda b: 10 * b, depth=3):
            got.append(b)
    assert got == [10, 20]


def test_resume_takes_bestval_and_restarts_the_schedule(tmp_path,
                                                       monkeypatch):
    """A run dir whose newest file is not its bestval one: the port resumes
    from the file and at the epoch JAX's ``find_checkpoint`` picks on the
    same listing, and its first update takes the learning rate JAX's
    restarted schedule gives (count 0), not the continued one."""
    yaml = _tiny_cfg(tmp_path)
    cfg = load_yaml(yaml)
    cfg["fusion"]["args"]["num_scenes_train"] = 4
    cfg["lr_scheduler"] = {"core_method": "multistep", "gamma": 0.1,
                           "step_size": [1]}
    save_yaml(cfg, yaml)
    run = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu", "--no_final_inference"])
    # a newer regular checkpoint beside bestval_at1
    os.link(os.path.join(run, "net_epoch1.pth"),
            os.path.join(run, "net_epoch3.pth"))
    listing = tmp_path / "as_ckpt"
    listing.mkdir()
    for name in os.listdir(run):
        if name.startswith("net_epoch"):
            (listing / name.replace(".pth", ".ckpt")).touch()
    want_epoch, want = jax_ckpt.find_checkpoint(str(listing))
    epoch, got = ckpt_lib.find_checkpoint(run)
    assert (epoch, os.path.basename(got)) == (
        want_epoch, os.path.basename(want).replace(".ckpt", ".pth")) == (
        1, "net_epoch_bestval_at1.pth")

    rates = []
    step = Trainer.train_step

    def record(self, batch):
        rates.append((self.step, self.schedule(self.step)))
        return step(self, batch)

    monkeypatch.setattr(Trainer, "train_step", record)
    train_tool.main(["--model_dir", run, "--epochs", "2", "--device", "cpu",
                     "--no_final_inference"])
    steps_per_epoch = 2
    sched = jax_schedule(copy.deepcopy(cfg["optimizer"]),
                         cfg["lr_scheduler"], steps_per_epoch)
    # epoch 1 only (resumed at 1, not 3): JAX's counts 0 and 1
    assert [s for s, _ in rates] == [0, 1]
    for count, lr in rates:
        assert lr == pytest.approx(float(sched(count)), rel=1e-6)
    assert rates[0][1] == pytest.approx(2e-3)
    assert float(sched(steps_per_epoch)) == pytest.approx(2e-4)
    assert ckpt_lib.find_checkpoint(run)[0] == 2
