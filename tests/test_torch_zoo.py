"""The port's training zoo against the JAX package, on the CPU: the MLP,
the ConvNet, ResNet (``resnet50-tiny``, both stems) and BERT
(``bert-tiny``), in float32, on the reference's flax params carried
across by ``convert.*_state_dict_from_jax``.

- Forward logits, train and eval mode, equal within 1e-5 of the logits'
  largest magnitude (5e-5 for ResNet's train mode, whose batch
  statistics are sums over the batch in another order).  The flax params
  are redrawn from a numpy seed first, so no batch-norm scale is zero
  (flax starts ``bn3`` at zero) and every shape trap shows: flax's
  asymmetric SAME padding at stride 2, the max pool's -inf padding, the
  biased running variance.  BERT with and without a padded
  ``attention_mask``.
- BERT's MLM mask bits equal ``jax.random.bernoulli``'s.
- The registry's flop models, batches, init and refusals by ROADMAP item
  (a model with no LM head refused by generate, the server and the CLI);
  the rest of the zoo (MoE-GPT, T5, ViT): ``train.main``'s first loss on
  each tiny config (and t5-tiny on span corruption) equals the
  reference's ``train.main`` from the same weights (float32 on both
  sides: rtol 1e-5; a 10x aux weight or a dropped target mask fails
  it), and
  ``--dataset span-corruption`` refuses a decoder-only model with the
  reference's message.

One optimizer step of each model against the reference's ``TrainStep``
is in ``test_torch_zoo_train.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import convert, prng
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models.registry import get_model as t_get_model

torch.set_num_threads(2)

CONVERT = {"mlp": convert.mlp_state_dict_from_jax,
           "convnet": convert.convnet_state_dict_from_jax,
           "resnet50-tiny": convert.resnet_state_dict_from_jax,
           "bert-tiny": convert.bert_state_dict_from_jax}


def _redraw(tree, seed):
    """Every leaf redrawn: normal * 0.3, scales around 1 and variances
    in [0.5, inf), so batch norms neither zero a branch nor divide by
    ~0."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        r = 0.3 * rng.standard_normal(x.shape)
        if "'var'" in name:
            r = 0.5 + np.abs(r)
        elif "scale" in name:
            r = 1.0 + r
        return r.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sd(name, variables, cfg):
    params = _np(variables["params"])
    if "batch_stats" in variables:
        return CONVERT[name](params, cfg, _np(variables["batch_stats"]))
    return CONVERT[name](params, cfg)


@functools.lru_cache(maxsize=None)
def _flax(name, batch_size, over):
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, **dict(over))
    batch = j_get_model(name).make_batch(batch_size)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     batch["inputs"])
    return jmodel, _redraw(dict(variables), 11), batch


def _pair(name, batch_size=4, **over):
    """(flax model, redrawn flax variables, port model with the same
    weights, the registry's numpy batch), float32."""
    tspec = t_get_model(name)
    jmodel, variables, batch = _flax(name, batch_size,
                                     tuple(sorted(over.items())))
    tmodel = tspec.init_params(seed=1, device="cpu", train=True,
                               dtype=torch.float32, **over)
    tmodel.load_state_dict(_port_sd(name, variables, tmodel.cfg),
                           strict=True)
    return jmodel, variables, tmodel, batch


def _close(got, want, rel, what):
    want = np.asarray(want)
    assert np.isfinite(want).all(), what
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, equal_nan=False,
        atol=rel * max(float(np.abs(want).max()), 1e-12), err_msg=what)


FORWARD = [("mlp", {}), ("convnet", {}), ("resnet50-tiny", {}),
           ("resnet50-tiny", {"stem": "space_to_depth"}),
           ("bert-tiny", {})]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,over", FORWARD,
                         ids=[f"{n}-{o.get('stem', 'default')}"
                              for n, o in FORWARD])
def test_forward_logits_equal_reference(name, over, train):
    jmodel, variables, tmodel, batch = _pair(name, **over)
    x = batch["inputs"]
    if "batch_stats" in variables:
        out = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=train,
            mutable=["batch_stats"] if train else False))(variables, x)
        want, new = out if train else (out, None)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=train))(
            variables, x)
        new = None
    got = tmodel(torch.as_tensor(x), train=train).detach().numpy()
    _close(got, want, 5e-5 if new is not None else 1e-5, name)
    if new is not None:
        # Train mode advanced the running averages as flax's merge does.
        sd = _port_sd(name, {"params": variables["params"],
                             "batch_stats": new["batch_stats"]}, tmodel.cfg)
        for key, t in tmodel.state_dict().items():
            if "running" in key:
                _close(t.numpy(), sd[key].numpy(), 1e-5, key)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_with_attention_mask(masked):
    jmodel, variables, tmodel, batch = _pair("bert-tiny")
    x = batch["inputs"]
    mask = None
    if masked:
        mask = np.ones(x.shape, np.int32)
        mask[1, 40:] = 0
        mask[3, 7:] = 0
    want = jax.jit(lambda v, x, m: jmodel.apply(v, x, attention_mask=m))(
        variables, x, mask)
    got = tmodel(torch.as_tensor(x), attention_mask=None if mask is None
                 else torch.as_tensor(mask)).detach().numpy()
    _close(got, want, 1e-5, f"masked={masked}")


def test_padding_is_flax_same_not_symmetric():
    """The traps are live: torch's symmetric padding at the stride-2
    convolutions and the max pool moves ResNet's logits."""
    from polyaxon_tpu_torch.models import layers

    jmodel, variables, tmodel, batch = _pair("resnet50-tiny")
    want = np.asarray(jax.jit(jmodel.apply)(variables, batch["inputs"]))
    assert layers._same_pads(224, 7, 2) == (2, 3)
    assert layers._same_pads(112, 3, 2) == (0, 1)
    assert layers._same_pads(32, 3, 1) == (1, 1)
    symmetric = lambda n, k, s: ((k - 1) // 2, (k - 1) // 2)  # noqa: E731
    real = layers._same_pads
    try:
        layers._same_pads = symmetric
        import polyaxon_tpu_torch.models.resnet as tres
        tres._same_pads = symmetric
        got = tmodel(torch.as_tensor(batch["inputs"])).detach().numpy()
    finally:
        layers._same_pads = real
        tres._same_pads = real
    assert np.abs(got - want).max() > 1e-2


def test_mlm_mask_bits_equal_jax_bernoulli():
    for seed in (0, 5, 123456789):
        for shape in ((8, 64), (32, 512), (3, 7)):
            want = np.asarray(jax.random.bernoulli(
                jax.random.PRNGKey(seed), 0.15, shape))
            got = prng.bernoulli(prng.PRNGKey(seed), 0.15, shape).numpy()
            np.testing.assert_array_equal(got, want)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    np.testing.assert_array_equal(
        prng.bernoulli(prng.fold_in(prng.PRNGKey(2), 1), 0.15,
                       (4, 64)).numpy(),
        np.asarray(jax.random.bernoulli(key, 0.15, (4, 64))))


@pytest.mark.parametrize("name", ["mlp", "convnet", "resnet50",
                                  "resnet50-tiny", "bert-base",
                                  "bert-tiny", "moe-gpt-small",
                                  "moe-gpt-tiny", "t5-small", "t5-tiny",
                                  "vit-base", "vit-tiny"])
def test_registry_entries_match_reference(name):
    j, t = j_get_model(name), t_get_model(name)
    assert t.default_batch_size == j.default_batch_size
    a, b = t.make_batch(3), j.make_batch(3)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert (t.train_flops is None) == (j.train_flops is None)
    if j.train_flops is not None:
        assert t.train_flops(8) == j.train_flops(8)
    if j.attn_flops is not None:
        assert t.attn_flops(8, t.make_model(device="meta").cfg) == \
            j.attn_flops(8, j.make_model().cfg)


def test_init_follows_flax_defaults():
    """lecun-normal kernels by fan-in, zero biases, unit scales and
    ``bn3`` at zero (its residual branch starts as the identity)."""
    model = t_get_model("resnet50-tiny").init_params(seed=0, device="cpu")
    block = model.stage1_block1
    assert not block.bn3.weight.any() and bool((block.bn1.weight == 1).all())
    fan_in = block.conv2.weight[0].numel()
    assert abs(block.conv2.weight.std().item() * fan_in ** 0.5 - 1) < 0.15
    assert not model.head.bias.any()


_ITEM_IDS = [
    "argv0-Parallelism and meshes", "argv1-Parallelism and meshes",
    "argv2-Parallelism and meshes", "argv3-Parallelism and meshes",
    "argv4-requires a seq2seq \\(encoder-decoder\\) model; "
    "'bert-tiny' is not",
    "argv5-span-corruption requires --data-dir",
    "argv6-Parallelism and meshes"]


@pytest.mark.parametrize("argv,item", [
    (["--model", "moe-gpt-tiny", "--strategy", "dp:-1,ep:4"],
     "do not divide device count 1"),
    (["--model", "t5-tiny", "--strategy", "dp:-1,tp:2"],
     "do not divide device count 1"),
    (["--model", "vit-tiny", "--strategy", "dp:2"],
     "do not divide device count 1"),
    (["--model", "moe-gpt-small", "--strategy", "dp:-1,sp:2,ep:2",
      "--sp-mode", "ring"],
     "do not divide device count 1"),
    (["--model", "bert-tiny", "--dataset", "span-corruption",
      "--data-dir", "."],
     "requires a seq2seq \\(encoder-decoder\\) model; 'bert-tiny' is not"),
    (["--model", "t5-tiny", "--dataset", "span-corruption"],
     "span-corruption requires --data-dir"),
    (["--model", "resnet50-tiny", "--strategy", "dp:2"],
     "do not divide device count 1"),
], ids=_ITEM_IDS)
def test_unported_refused_by_roadmap_item(argv, item, tmp_path,
                                          monkeypatch):
    """What stays refused: span corruption without a seq2seq model or a
    data directory with the reference's messages.  ``dp:2`` and the
    reference's tp / ep / sp strategies of the zoo's examples
    (``dp:-1,ep:4``, ``dp:-1,tp:2``, MoE-GPT's ``dp:-1,sp:2,ep:2``) in
    one process with no gang raise the reference's own ``MeshError`` (a
    gang trains them: ``test_torch_gang.py``, ``test_torch_tp.py``,
    ``test_torch_ep.py``, ``test_torch_compose.py``).  The ids are the
    cases' earlier ones."""
    from polyaxon_tpu_torch.parallel.mesh import MeshError

    monkeypatch.chdir(tmp_path)
    with pytest.raises((SystemExit, MeshError), match=item):
        ttrain.main(["--cpu", "--steps", "1", *argv])


REST = ("moe-gpt-tiny", "t5-tiny", "vit-tiny")


def test_rest_of_the_zoo_is_registered():
    for name in ("moe-gpt-small", "moe-gpt-tiny", "t5-small", "t5-tiny",
                 "vit-base", "vit-tiny"):
        model = t_get_model(name).make_model(device="meta")
        assert type(model).__name__ == type(
            j_get_model(name).make_model()).__name__
    with pytest.raises(KeyError, match="unknown model"):
        t_get_model("t5-large")


@pytest.mark.parametrize("name", ["vit-tiny", "mlp", "resnet50-tiny",
                                  "bert-tiny", "convnet"])
def test_generate_refuses_a_model_with_no_lm_head(name):
    """A model with nothing to decode is refused by one named message
    (ROADMAP Queue 3: Generate on a model with no LM head) before any
    program or engine is built: by ``generate`` and its siblings, by
    ``ModelServer`` and by the CLI's ``generate`` and ``serve`` (judged
    on a meta model there).  The reference fails the same calls with a
    TypeError from inside the model."""
    from click.testing import CliRunner

    from polyaxon_tpu_torch.cli.main import cli
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving import ModelServer

    model = t_get_model(name).make_model(device="cpu")
    msg = "no causal LM head .* Generate on a model with no LM head"
    calls = (
        lambda: G.generate(model, [[1, 2]], max_new_tokens=2),
        lambda: G.generate_positional(model, [[1, 2]], max_new_tokens=2),
        lambda: G.generate_beam(model, [[1, 2]], max_new_tokens=2),
        lambda: G.generate_speculative(model, model, [[1, 2]],
                                       max_new_tokens=2),
        lambda: ModelServer(model))
    for call in calls:
        with pytest.raises(NotImplementedError, match=msg):
            call()
    for argv in (["generate", "--prompt", "1,2"], ["serve"]):
        res = CliRunner().invoke(cli, [*argv, "--cpu", "--model", name])
        assert res.exit_code != 0
        assert "Generate on a model with no LM head" in res.output


# train.main's argv for each case of the rest of the zoo; "span" is
# t5-tiny on --dataset span-corruption (masked targets and encoder).
TRAIN_CASES = {"moe-gpt-tiny": ("moe-gpt-tiny", ()),
               "t5-tiny": ("t5-tiny", ()),
               "vit-tiny": ("vit-tiny", ()),
               "t5-tiny-span": ("t5-tiny", ("--dataset", "span-corruption"))}
REST_CONVERT = {"moe-gpt-tiny": convert.moe_gpt_state_dict_from_jax,
                "t5-tiny": convert.t5_state_dict_from_jax,
                "vit-tiny": convert.vit_state_dict_from_jax}


def _tracked(store_cls, home, names=("loss", "aux_loss")):
    """The first step's tracked metrics of the one run under ``home``,
    at full precision (the step line prints 4 digits)."""
    store = store_cls(str(home))
    (run,) = store.list_runs()
    return {k: ev[0]["value"] for k in names
            if (ev := store.read_events(run["uuid"], "metric", k))}


def _argv(case, tmp):
    name, extra = TRAIN_CASES[case]
    argv = ["--model", name, "--steps", "1", "--batch-size", "8",
            "--log-every", "1", "--prefetch", "0", *extra]
    if extra:
        data = tmp / "data"
        data.mkdir(exist_ok=True)
        # Ids below vocab - 100: the top 100 are the sentinels.
        np.save(data / "tokens.npy", np.random.RandomState(0).randint(
            2, 400, 20000).astype(np.int32))
        argv += ["--data-dir", str(data)]
    return argv


@functools.lru_cache(maxsize=None)
def _reference_run(case):
    """The reference's ``train.main`` for one step at batch 8, its
    models in float32 (a registry that passes ``dtype=float32``): its
    tracked first metrics and the params it started from
    (``model.init(PRNGKey(0), sample)``, as its ``train.main`` draws
    them)."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from polyaxon_tpu import data as jdata
    from polyaxon_tpu import train as jtrain
    from polyaxon_tpu.client.store import FileRunStore
    from polyaxon_tpu.models import registry as jreg

    def f32_spec(model_name):
        spec = j_get_model(model_name)
        return dataclasses.replace(spec, make_model=functools.partial(
            spec.make_model, dtype=jnp.float32))

    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        tmp = Path(tmp)
        mp.chdir(tmp)
        mp.setenv("POLYAXON_TPU_HOME", str(tmp / "home"))
        mp.setattr(jreg, "get_model", f32_spec)
        # Batch 8: the reference rounds a batch to its data axes (the
        # tests' 8 host devices).
        assert jtrain.main(_argv(case, tmp)) == 0
        want = _tracked(FileRunStore, tmp / "home")
    jspec = f32_spec(TRAIN_CASES[case][0])
    sample = jdata.synthetic_dataset(jspec, 2, seed=0).sample(2)
    variables = jax.jit(jspec.make_model().init)(jax.random.PRNGKey(0),
                                                 sample["inputs"])
    return want, _np(variables["params"])


def _port_run(case, tmp_path, monkeypatch, fault=None):
    """The port's ``train.main`` on the same case from the reference's
    params, float32: its tracked first metrics.  ``fault`` breaks the
    wiring on purpose: "aux_weight" (10x the config's) or
    "target_mask" (the loss reads no target mask)."""
    import dataclasses

    from polyaxon_tpu_torch.client import FileRunStore
    from polyaxon_tpu_torch.models import registry as treg

    name = TRAIN_CASES[case][0]
    _, params = _reference_run(case)

    def init_params(self, batch_size=2, seed=0, device=None, train=False,
                    **over):
        if fault == "aux_weight":
            over["aux_weight"] = 10 * self.make_model(
                device="meta").cfg.aux_weight
        model = self.make_model(device=device, param_dtype=torch.float32,
                                dtype=torch.float32, **over)
        model.load_state_dict(REST_CONVERT[name](params, model.cfg))
        return model.train()

    def get_model(model_name):
        spec = t_get_model(model_name)
        if fault != "target_mask":
            return spec

        def loss_fn(model):
            inner = spec.loss_fn(model)
            return lambda batch, rng=None: inner(
                {k: v for k, v in batch.items() if k != "target_mask"},
                rng)
        return dataclasses.replace(spec, loss_fn=loss_fn)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setattr(treg.ModelSpec, "init_params", init_params)
    monkeypatch.setattr(treg, "get_model", get_model)
    assert ttrain.main(["--cpu", *_argv(case, tmp_path)]) == 0
    return _tracked(FileRunStore, tmp_path / "home")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_main_first_loss_equals_reference(case, tmp_path,
                                                monkeypatch):
    """Both packages' ``train.main`` for one step at batch 8 from the
    reference's init, in float32 (the port's registry pointed at those
    weights): the first tracked loss (and MoE's aux loss) agree within
    float32 summation order."""
    want, _ = _reference_run(case)
    got = _port_run(case, tmp_path, monkeypatch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case,fault", [("moe-gpt-tiny", "aux_weight"),
                                        ("t5-tiny-span", "target_mask")])
def test_train_main_first_loss_catches_wiring_faults(case, fault,
                                                     tmp_path, monkeypatch):
    """The comparison above fails on a wiring fault: MoE's aux loss
    weighted 10x (about 1% of the loss at init), or T5's loss averaged
    over padded targets."""
    want, _ = _reference_run(case)
    got = _port_run(case, tmp_path, monkeypatch, fault=fault)
    assert abs(got["loss"] - want["loss"]) > 1e-3 * abs(want["loss"])


ZOO_EXAMPLES = {"mnist.yaml": "polyaxon_tpu_torch.models.train_mnist",
                "convnet_hyperband.yaml": "polyaxon_tpu_torch.train",
                "resnet50_job.yaml": "polyaxon_tpu_torch.train",
                "bert_job.yaml": "polyaxon_tpu_torch.train",
                "bert_finetune.yaml": "polyaxon_tpu_torch.train"}


@pytest.mark.parametrize("example", sorted(ZOO_EXAMPLES))
def test_zoo_examples_are_single_card_jobs(example):
    """Each zoo example compiles as a ``job`` running the port's entry
    point (the reference's tfjob / pytorchjob gangs need meshes)."""
    from pathlib import Path

    from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile

    path = Path(ttrain.__file__).parent / "examples" / example
    params = {"weights": "w.pt"} if "finetune" in example else None
    run = check_polyaxonfile([str(path)], params=params).component.run
    assert run.kind == "job"
    assert run.container.command == ["python", "-m", ZOO_EXAMPLES[example]]


@pytest.mark.parametrize("example", ["resnet50_job.yaml", "bert_job.yaml"])
def test_gang_kinds_refused_by_roadmap_item(example, monkeypatch,
                                            tmp_path, capsys):
    """The reference's tfjob / pytorchjob gangs of these examples run one
    process per replica with the PTPU_* block (``test_torch_gang.py``
    trains such gangs).  ``PTPU_NUM_PROCESSES`` with no
    ``PTPU_COORDINATOR_ADDRESS`` is no managed gang: the reference's
    ``topology_from_env`` returns None, and the run trains as one
    process."""
    from polyaxon_tpu.parallel.bootstrap import \
        topology_from_env as j_topology_from_env
    from polyaxon_tpu_torch.parallel.bootstrap import topology_from_env

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PTPU_NUM_PROCESSES", "4")
    monkeypatch.delenv("PTPU_COORDINATOR_ADDRESS", raising=False)
    assert topology_from_env() is None and j_topology_from_env() is None
    model = "resnet50-tiny" if "resnet" in example else "bert-tiny"
    assert ttrain.main(["--cpu", "--model", model, "--steps", "1",
                        "--batch-size", "4", "--no-resume"]) == 0
    out = capsys.readouterr().out
    assert "slice health" not in out and "step 1/1 loss=" in out
