"""Held-out evaluation and the digits dataset, the port against the JAX
package on the CPU:

- ``data.load_digits`` (the packaged ``digits.csv.gz``) equals
  ``sklearn.datasets.load_digits()`` exactly, and ``digits_dataset``'s
  train / eval splits and batches equal ``polyaxon_tpu.data``'s.
- ``train.make_eval_fn``'s accuracy equals the reference's
  ``make_eval_fn`` on the same converted params (the MLP, and
  ``resnet50-tiny`` whose batch norms must read their running averages),
  the eval split's remainder batch counted exactly.
- ``train_mnist`` (the MLP on digits, 8 epochs, eval every 40) reaches
  ``eval_accuracy >= 0.95`` on the CPU; ``--target-metric
  eval_accuracy>=x`` ends a run early; ``--eval-every`` snaps up to the
  next log step as the reference's trainer does; the final
  ``eval_accuracy`` reaches the run's tracked outputs.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyaxon_tpu.data as jdata
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel.strategies import make_batch_sharding
from polyaxon_tpu.train import make_eval_fn as j_make_eval_fn
from polyaxon_tpu_torch import data as tdata
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models import train_mnist
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from test_torch_zoo import CONVERT, _redraw

torch.set_num_threads(2)


def test_digits_equal_sklearn():
    from sklearn.datasets import load_digits

    want = load_digits()
    images, labels = tdata.load_digits()
    np.testing.assert_array_equal(images, want.images)
    np.testing.assert_array_equal(labels, want.target)
    assert images.dtype == want.images.dtype


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_digits_splits_equal_reference(split, seed):
    j = jdata.digits_dataset(64, split=split, seed=seed)
    t = tdata.digits_dataset(64, split=split, seed=seed)
    assert t.n == j.n and t.steps_per_epoch == j.steps_per_epoch
    for key in ("inputs", "labels"):
        np.testing.assert_array_equal(t.arrays[key], j.arrays[key])
        assert t.arrays[key].dtype == j.arrays[key].dtype
    assert t.arrays["inputs"].shape[1:] == (8, 8, 1)
    for a, b in zip(j.epochs(2), t.epochs(2)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name", ["mlp", "resnet50-tiny"])
def test_evaluate_equals_reference(name):
    ds = tdata.digits_dataset(128, split="eval")
    sample = ds.sample(2)["inputs"]
    jmodel = j_get_model(name).make_model(dtype=jnp.float32)
    variables = _redraw(dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), sample)), 3)
    spec = t_get_model(name)
    tmodel = spec.make_model(device="cpu", dtype=torch.float32,
                             **spec.input_overrides(sample))
    params = jax.tree.map(np.asarray, variables["params"])
    args = (jax.tree.map(np.asarray, variables["batch_stats"]),) \
        if "batch_stats" in variables else ()
    tmodel.load_state_dict(CONVERT[name](params, tmodel.cfg, *args))
    tmodel.train()
    mesh = build_mesh(MeshSpec.from_dict({"dp": 1}),
                      devices=jax.devices()[:1])
    want = j_make_eval_fn(jmodel, mesh, make_batch_sharding(mesh))(
        variables, jdata.digits_dataset(128, split="eval"))
    seen = []
    real = ds.epoch
    ds.epoch = lambda e: (seen.append(len(b["labels"])) or b
                          for b in real(e))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    got = ttrain.make_eval_fn(tmodel)(ds)
    assert got == want and 0 < got < 1
    assert seen == [128, 128, 103] and sum(seen) == ds.n == 359
    assert tmodel.training       # back in train mode
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k     # eval advances nothing


def _lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("step ")]


def test_train_mnist_reaches_target_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)
    assert train_mnist.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    final = float(re.search(r"final eval_accuracy=(\S+)", out).group(1))
    assert final >= 0.95, out[-2000:]
    evals = [int(ln.split()[1].split("/")[0]) for ln in _lines(out)
             if "eval_accuracy=" in ln]
    # 1438 train images, batch 64: 22 steps an epoch, 176 in 8.
    assert evals == [40, 80, 120, 160]
    assert "176/176" in _lines(out)[-1]


def test_target_metric_ends_the_run_early(tmp_path, monkeypatch, capsys):
    from polyaxon_tpu_torch.client import FileRunStore

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path))
    monkeypatch.setenv("POLYAXON_TPU_RUN_UUID", "mnist")
    assert ttrain.main(["--cpu", "--model", "mlp", "--dataset", "digits",
                        "--epochs", "20", "--eval-every", "10",
                        "--target-metric", "eval_accuracy>=0.9"]) == 0
    out = capsys.readouterr().out
    assert "target eval_accuracy>=0.9 reached" in out
    last = _lines(out)[-1]
    step = int(last.split()[1].split("/")[0])
    assert step < 20 * 22 and step % 10 == 0
    assert float(re.search(r"eval_accuracy=(\S+)", last).group(1)) >= 0.9
    run = FileRunStore(str(tmp_path)).get_run("mnist")
    final = float(re.search(r"final eval_accuracy=(\S+)", out).group(1))
    assert run["outputs"]["eval_accuracy"] == pytest.approx(final, abs=5e-5)


@pytest.mark.parametrize("every,log,steps", [(15, 10, 50), (7, 5, 23)])
def test_eval_every_snaps_to_log_steps_as_reference(every, log, steps,
                                                    tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)
    assert ttrain.main(["--cpu", "--model", "mlp", "--dataset", "digits",
                        "--steps", str(steps), "--eval-every", str(every),
                        "--log-every", str(log)]) == 0
    got = [int(ln.split()[1].split("/")[0])
           for ln in _lines(capsys.readouterr().out)
           if "eval_accuracy=" in ln]
    want = sorted({min(-(-due // log) * log, steps)
                   for due in range(every, steps + 1, every)})
    assert got == want
