"""HuggingFace interop of the port (``models/import_hf.py``), on the CPU,
against ``transformers`` models built in process from small configs (no
download):

- ``load_hf_gpt2`` / ``load_hf_llama`` / ``load_hf_bert``: the port's
  float32 logits equal transformers' on the same tokens (atol and rtol
  2e-4, the reference's ``tests/test_import_hf.py`` bound; BERT with
  ``token_type_ids`` of zeros, which HF adds whether given or not).
- ``export_hf_*``: loads into transformers with only non-parameter
  buffers missing, gives the same logits, and ``load ∘ export`` is the
  identity on the port's state dict (bitwise).  The port's and the
  reference's loaders agree on the same checkpoint.
- A shape mismatch raises naming the HF tensor; an untied BERT decoder
  and an untied head under ``tie_embeddings`` are refused.
- ``train.main --cpu --init-hf`` starts from the file: its first loss
  equals the registry model's loaded from that file (bf16 compute, the
  exact GELU for BERT; rtol 1e-6) and, for the Llama, transformers' own
  float32 loss within bf16 rounding (rtol 2e-2).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from polyaxon_tpu.models import import_hf as j_import_hf  # noqa: E402
from polyaxon_tpu_torch import convert  # noqa: E402
from polyaxon_tpu_torch import train as ttrain  # noqa: E402
from polyaxon_tpu_torch.models import import_hf  # noqa: E402
from polyaxon_tpu_torch.models.bert import BertConfig, BertModel  # noqa: E402
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model  # noqa: E402
from polyaxon_tpu_torch.models.llama import (LlamaConfig,  # noqa: E402
                                             LlamaModel)

torch.set_num_threads(2)
F32 = torch.float32


def _gpt2():
    hf_cfg = transformers.GPT2Config(
        vocab_size=1024, n_embd=64, n_layer=2, n_head=4, n_positions=128,
        layer_norm_epsilon=1e-5, attn_pdrop=0.0, embd_pdrop=0.0,
        resid_pdrop=0.0)
    cfg = GPT2Config(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=4, max_position=128, dtype=F32)
    return (hf_cfg, transformers.GPT2LMHeadModel, cfg, GPT2Model,
            import_hf.load_hf_gpt2, import_hf.export_hf_gpt2, {})


def _llama(tie=False):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_dropout=0.0, tie_word_embeddings=tie)
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      max_position=128, dtype=F32, tie_embeddings=tie)
    return (hf_cfg, transformers.LlamaForCausalLM, cfg, LlamaModel,
            import_hf.load_hf_llama, import_hf.export_hf_llama, {})


def _bert():
    hf_cfg = transformers.BertConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=128, type_vocab_size=2, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-12)
    cfg = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, max_position=128,
                     gelu_approximate=False, dtype=F32)
    return (hf_cfg, transformers.BertForMaskedLM, cfg, BertModel,
            import_hf.load_hf_bert, import_hf.export_hf_bert,
            {"token_type_ids": "zeros"})


FAMILIES = {"gpt2": _gpt2, "llama": _llama, "bert": _bert}


def _port_logits(model, tokens, kw):
    kw = {k: torch.zeros_like(tokens) for k in kw}
    with torch.no_grad():
        return model(tokens, **kw).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loaded_logits_equal_transformers(family):
    hf_cfg, hf_cls, cfg, cls, load, _, kw = FAMILIES[family]()
    torch.manual_seed(0)
    hf = hf_cls(hf_cfg).eval()
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
    model = cls(cfg, device="cpu").eval()
    convert.load_state_dict(model, load(hf.state_dict(), cfg))
    np.testing.assert_allclose(_port_logits(model, tokens, kw), want,
                               atol=2e-4, rtol=2e-4)
    # The reference's loader reads the same checkpoint onto the same
    # numbers.
    jload = getattr(j_import_hf, load.__name__)
    jcfg = jax_cfg(family)
    jtree = jax.tree.map(np.asarray, jload(hf.state_dict(), jcfg)["params"])
    ref_sd = CONVERT[family](jtree, model.cfg)
    for name, t in model.state_dict().items():
        if name in ref_sd:
            torch.testing.assert_close(t, ref_sd[name], rtol=0, atol=0)


def jax_cfg(family):
    import jax.numpy as jnp

    from polyaxon_tpu.models.bert import BertConfig as JB
    from polyaxon_tpu.models.gpt2 import GPT2Config as JG
    from polyaxon_tpu.models.llama import LlamaConfig as JL

    if family == "gpt2":
        return JG(vocab_size=1024, hidden_size=64, num_layers=2,
                  num_heads=4, max_position=128, dtype=jnp.float32)
    if family == "llama":
        return JL(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, num_kv_heads=2,
                  max_position=128, dtype=jnp.float32)
    return JB(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position=128,
              gelu_approximate=False, dtype=jnp.float32)


CONVERT = {"gpt2": convert.gpt2_state_dict_from_jax,
           "llama": convert.llama_state_dict_from_jax,
           "bert": convert.bert_state_dict_from_jax}


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["llama-tied"])
def test_export_loads_into_transformers_and_round_trips(family):
    hf_cfg, hf_cls, cfg, cls, load, export, kw = \
        _llama(tie=True) if family == "llama-tied" else FAMILIES[family]()
    gen = torch.Generator().manual_seed(4)
    model = cls(cfg, device="cpu").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    sd = export(model, cfg)
    torch.manual_seed(1)
    hf = hf_cls(hf_cfg).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all("position_ids" in k or "token_type_ids" in k
               or k.endswith("attn.bias") or "masked_bias" in k
               for k in missing), missing
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
    np.testing.assert_allclose(_port_logits(model, tokens, kw), want,
                               atol=2e-4, rtol=2e-4)
    back = load(sd, cfg)
    mine = model.state_dict()
    assert sorted(back) == sorted(mine)
    for name, t in mine.items():
        assert torch.equal(back[name], t), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shape_mismatch_names_the_tensor(family):
    hf_cfg, hf_cls, cfg, cls, load, _, _ = FAMILIES[family]()
    hf = hf_cls(hf_cfg).eval()
    small = type(cfg)(**{**cfg.__dict__,
                         "hidden_size": cfg.hidden_size // 2,
                         "num_heads": cfg.num_heads // 2})
    with pytest.raises(ValueError,
                       match=r"\.weight: shape \(\d+, \d+\) does not match"):
        load(hf.state_dict(), small)


def test_untied_heads_are_refused():
    hf_cfg, hf_cls, cfg, _, load, _, _ = _bert()
    sd = dict(hf_cls(hf_cfg).state_dict())
    sd["cls.predictions.decoder.weight"] = torch.randn(1024, 64)
    with pytest.raises(ValueError, match="untied"):
        load(sd, cfg)
    hf_cfg, hf_cls, cfg, _, load, _, _ = _llama(tie=True)
    sd = dict(hf_cls(hf_cfg).state_dict())
    sd["lm_head.weight"] = torch.randn(512, 64)
    with pytest.raises(ValueError, match="untied"):
        load(sd, cfg)


def _first_loss(home, uuid):
    from polyaxon_tpu_torch.client import FileRunStore

    events = FileRunStore(str(home)).read_events(uuid, "metric", "loss")
    return events[0]["value"]


@pytest.mark.parametrize("family,model_name", [("llama", "llama-tiny"),
                                               ("bert", "bert-tiny")])
def test_init_hf_through_train_main(family, model_name, tmp_path,
                                    monkeypatch):
    """The file's weights train: the first tracked loss equals the loss
    of the registry's model (bf16 compute) loaded from the same file on
    the first batch and the first step's key (rtol 1e-6), and is within
    bf16 rounding (rtol 2e-2) of transformers' own float32 loss for the
    Llama (BERT's differs by HF's type embedding, which the zoo adds
    only given ``token_type_ids``)."""
    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models.registry import get_model

    hf_cfg, hf_cls, _, _, load, _, _ = FAMILIES[family]()
    torch.manual_seed(0)
    hf = hf_cls(hf_cfg).eval()
    path = tmp_path / "hf.pt"
    torch.save(hf.state_dict(), path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path))
    monkeypatch.setenv("POLYAXON_TPU_RUN_UUID", "ft")
    assert ttrain.main(["--cpu", "--model", model_name, "--init-hf",
                        str(path), "--steps", "1", "--batch-size", "2",
                        "--log-every", "1", "--prefetch", "0"]) == 0
    got = _first_loss(tmp_path, "ft")
    spec = get_model(model_name)
    args = ttrain.build_argparser().parse_args(["--model", model_name])
    batch = next(ttrain.make_datasets(args, spec, 2)[0].epoch(0))
    over = ttrain._HF_MODEL_KW.get(family, {})
    ref = spec.make_model(device="cpu", param_dtype=F32, **over)
    assert ref.cfg.dtype == torch.bfloat16
    convert.load_state_dict(ref, load(hf.state_dict(), ref.cfg))
    key = prng.split(prng.PRNGKey(0))[1]
    want = spec.loss_fn(ref)(batch, key)[0].item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if family == "llama":
        tokens = torch.as_tensor(batch["inputs"])
        with torch.no_grad():
            hf_loss = hf(tokens, labels=tokens).loss.item()
        np.testing.assert_allclose(got, hf_loss, rtol=2e-2)


# -- T5 and ViT ----------------------------------------------------------

def _t5(ff="relu", tie=True):
    from polyaxon_tpu_torch.models.t5 import T5Config, T5Model

    hf_cfg = transformers.T5Config(
        vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_decoder_layers=2, num_heads=4,
        relative_attention_num_buckets=32,
        relative_attention_max_distance=128, dropout_rate=0.0,
        layer_norm_epsilon=1e-6, feed_forward_proj=ff,
        tie_word_embeddings=tie, decoder_start_token_id=0, pad_token_id=0)
    cfg = T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_decoder_layers=2, num_heads=4,
                   max_position=128, feed_forward=ff, tie_embeddings=tie,
                   dtype=F32)
    return hf_cfg, cfg, T5Model


def _vit():
    from polyaxon_tpu_torch.models.vit import ViTConfig, ViTModel

    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, num_channels=3, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        hidden_act="gelu", layer_norm_eps=1e-6, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, num_labels=10, qkv_bias=True)
    cfg = ViTConfig(image_size=32, patch_size=8, num_classes=10,
                    hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, gelu_approximate=False,
                    dtype=F32)
    return hf_cfg, cfg, ViTModel


T5_KINDS = [("relu", True), ("gated-gelu", False)]


def _t5_inputs():
    rng = np.random.RandomState(5)
    return (torch.from_numpy(rng.randint(0, 512, (2, 12))),
            torch.from_numpy(rng.randint(0, 512, (2, 7))))


def _t5_logits(model, enc, dec):
    with torch.no_grad():
        return model(enc, dec).numpy()


def _jax_t5_cfg(cfg):
    import dataclasses

    import jax.numpy as jnp

    from polyaxon_tpu.models.t5 import T5Config as J

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(J)
          if f.name != "dtype"}
    return J(**kw, dtype=jnp.float32)


@pytest.mark.parametrize("ff,tie", T5_KINDS)
def test_t5_load_and_export_against_transformers(ff, tie):
    """HF's logits from the loaded weights (v1.0 tied ReLU, v1.1
    untied gated-GELU); the reference's loader reads the same numbers;
    the export loads back into HF with the same logits, and
    ``load(export)`` is the identity."""
    hf_cfg, cfg, cls = _t5(ff, tie)
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    enc, dec = _t5_inputs()
    with torch.no_grad():
        want = hf(input_ids=enc, decoder_input_ids=dec).logits.numpy()
    model = cls(cfg, device="cpu").eval()
    convert.load_state_dict(model, import_hf.load_hf_t5(hf.state_dict(),
                                                        cfg))
    np.testing.assert_allclose(_t5_logits(model, enc, dec), want,
                               atol=2e-4, rtol=2e-4)
    jtree = jax.tree.map(np.asarray, j_import_hf.load_hf_t5(
        hf.state_dict(), _jax_t5_cfg(cfg))["params"])
    ref_sd = convert.t5_state_dict_from_jax(jtree, cfg)
    mine = model.state_dict()
    assert sorted(ref_sd) == sorted(mine)
    for name, t in mine.items():
        torch.testing.assert_close(t, ref_sd[name], rtol=0, atol=0)
    sd = import_hf.export_hf_t5(model, cfg)
    torch.manual_seed(1)
    hf2 = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    missing, unexpected = hf2.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    with torch.no_grad():
        got = hf2(input_ids=enc, decoder_input_ids=dec).logits.numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    back = import_hf.load_hf_t5(sd, cfg)
    for name, t in mine.items():
        assert torch.equal(back[name], t), name


def test_t5_tied_and_untied_refusals():
    """The reference's two refusals: a tied config refuses an untied
    head, an untied config refuses a checkpoint with no lm_head."""
    hf_cfg, cfg, _ = _t5("relu", True)
    sd = dict(transformers.T5ForConditionalGeneration(hf_cfg).state_dict())
    sd["lm_head.weight"] = torch.randn(512, 64)
    with pytest.raises(ValueError, match="untied lm_head"):
        import_hf.load_hf_t5(sd, cfg)
    _, untied, _ = _t5("relu", False)
    sd.pop("lm_head.weight")
    with pytest.raises(ValueError, match="no lm_head.weight"):
        import_hf.load_hf_t5(sd, untied)


def test_vit_load_and_export_against_transformers():
    """HF's logits (NCHW pixels) from the loaded weights on the port's
    NHWC images; the reference's loader reads the same numbers; the
    export loads back into HF and round-trips bitwise."""
    import dataclasses

    import jax.numpy as jnp

    from polyaxon_tpu.models.vit import ViTConfig as J

    hf_cfg, cfg, cls = _vit()
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "cls_token" in name or "position" in name:
                p.normal_(0.0, 0.5)   # HF starts the CLS token at zero
    images = np.random.RandomState(6).rand(2, 32, 32, 3).astype("float32")
    nchw = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = hf(pixel_values=nchw).logits.numpy()
    model = cls(cfg, device="cpu").eval()
    convert.load_state_dict(model, import_hf.load_hf_vit(hf.state_dict(),
                                                         cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    jcfg = J(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(J)
                if f.name != "dtype"}, dtype=jnp.float32)
    jtree = jax.tree.map(np.asarray, j_import_hf.load_hf_vit(
        hf.state_dict(), jcfg)["params"])
    ref_sd = convert.vit_state_dict_from_jax(jtree, cfg)
    mine = model.state_dict()
    assert sorted(ref_sd) == sorted(mine)
    for name, t in mine.items():
        torch.testing.assert_close(t, ref_sd[name], rtol=0, atol=0)
    sd = import_hf.export_hf_vit(model, cfg)
    torch.manual_seed(1)
    hf2 = transformers.ViTForImageClassification(hf_cfg).eval()
    missing, unexpected = hf2.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    with torch.no_grad():
        np.testing.assert_allclose(hf2(pixel_values=nchw).logits.numpy(),
                                   want, atol=2e-4, rtol=2e-4)
    back = import_hf.load_hf_vit(sd, cfg)
    for name, t in mine.items():
        assert torch.equal(back[name], t), name
