"""The port's loading path against the JAX package's: the safetensors codec
(byte for byte), the HF name mapping (dense, Mixtral, e5 with and without
the ``bert.`` prefix, the tied and untied heads, sharded dirs), logits on
loaded weights, the export, the port's own checkpoint format, and the BPE
and HF tokenizers.

The HF state dicts are synthetic (the names, shapes and [out, in] layout of
real exports), written by the JAX package's writer.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import TINY_ENCODER as J_TINY_ENCODER
from k8s_llm_rca_tpu.config import TINY_MOE as J_TINY_MOE
from k8s_llm_rca_tpu.models import encoder as j_encoder
from k8s_llm_rca_tpu.models import llama as j_llama
from k8s_llm_rca_tpu.models import loader as j_loader
from k8s_llm_rca_tpu.utils import tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch.config import TINY, TINY_ENCODER, TINY_MOE
from k8s_llm_rca_tpu_torch.models import encoder, llama, loader
from k8s_llm_rca_tpu_torch.models.quant import (
    QuantTensor, QuantTensor4, quantize_params,
)
from k8s_llm_rca_tpu_torch.utils import checkpoint, tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)


def _rng_tensor(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32) * 0.05


def synth_llama_sd(cfg, rng):
    """A synthetic HF Llama/Mixtral state dict ([out, in] Linear layout)."""
    h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                       cfg.intermediate_size)
    sd = {"model.embed_tokens.weight": _rng_tensor(rng, cfg.vocab_size, h),
          "model.norm.weight": _rng_tensor(rng, h)}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _rng_tensor(rng, cfg.vocab_size, h)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _rng_tensor(rng, h)
        sd[p + "post_attention_layernorm.weight"] = _rng_tensor(rng, h)
        sd[p + "self_attn.q_proj.weight"] = _rng_tensor(rng, q, h)
        sd[p + "self_attn.k_proj.weight"] = _rng_tensor(rng, kv, h)
        sd[p + "self_attn.v_proj.weight"] = _rng_tensor(rng, kv, h)
        sd[p + "self_attn.o_proj.weight"] = _rng_tensor(rng, h, q)
        if cfg.n_experts > 0:
            moe = p + "block_sparse_moe."
            sd[moe + "gate.weight"] = _rng_tensor(rng, cfg.n_experts, h)
            for e in range(cfg.n_experts):
                ep = f"{moe}experts.{e}."
                sd[ep + "w1.weight"] = _rng_tensor(rng, inter, h)
                sd[ep + "w2.weight"] = _rng_tensor(rng, h, inter)
                sd[ep + "w3.weight"] = _rng_tensor(rng, inter, h)
        else:
            sd[p + "mlp.gate_proj.weight"] = _rng_tensor(rng, inter, h)
            sd[p + "mlp.up_proj.weight"] = _rng_tensor(rng, inter, h)
            sd[p + "mlp.down_proj.weight"] = _rng_tensor(rng, h, inter)
    return sd


def synth_bert_sd(cfg, rng, prefix=""):
    h, inter = cfg.hidden_size, cfg.intermediate_size
    e = prefix + "embeddings."
    sd = {e + "word_embeddings.weight": _rng_tensor(rng, cfg.vocab_size, h),
          e + "position_embeddings.weight":
              _rng_tensor(rng, cfg.max_seq_len, h),
          e + "token_type_embeddings.weight": _rng_tensor(rng, 2, h),
          e + "LayerNorm.weight": 1 + _rng_tensor(rng, h),
          e + "LayerNorm.bias": _rng_tensor(rng, h)}
    for i in range(cfg.n_layers):
        p = f"{prefix}encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (inter, h)),
                            ("output.dense", (h, inter))):
            sd[p + name + ".weight"] = _rng_tensor(rng, *shape)
            sd[p + name + ".bias"] = _rng_tensor(rng, shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = 1 + _rng_tensor(rng, h)
            sd[p + ln + ".bias"] = _rng_tensor(rng, h)
    return sd


def _assert_trees_equal(port, jax_tree):
    """Every leaf of the port's tree equals the JAX tree's, bit for bit
    (bf16 through its 16-bit pattern)."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(jax_tree)
        for k in port:
            _assert_trees_equal(port[k], jax_tree[k])
    elif isinstance(port, list):
        assert len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            _assert_trees_equal(a, b)
    else:
        want = np.asarray(jax_tree)
        assert tuple(port.shape) == want.shape
        if port.dtype == torch.bfloat16:
            assert want.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(port.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(port.numpy(), want)


# ------------------------------------------------------------ the codec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_safetensors_bytes_equal_the_jax_writer(tmp_path, dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    arrays = {"float32": a, "bfloat16": a.astype(ml_dtypes.bfloat16),
              "int8": (a * 40).astype(np.int8)}
    tensors = {"w": arrays[dtype], "row": arrays[dtype][:1, :3],
               "empty": arrays[dtype][:0]}
    j_path, p_path = tmp_path / "j.safetensors", tmp_path / "p.safetensors"
    j_loader.write_safetensors(str(j_path), tensors)
    # the port writes torch tensors (bf16 carried by its bit pattern)
    loader.write_safetensors(str(p_path), {
        k: llama._tensor_from_numpy(v, "cpu", None)
        for k, v in tensors.items()})
    assert p_path.read_bytes() == j_path.read_bytes()
    back = loader.read_safetensors(str(j_path))
    _assert_trees_equal(back, tensors)


def test_sharded_dir_and_missing_checkpoint(tmp_path):
    """The port's sharded writer gives a dir both packages read; a dir
    without a checkpoint raises."""
    rng = np.random.default_rng(1)
    tensors = {f"t{i}": _rng_tensor(rng, 4, i + 1) for i in range(6)}
    paths = loader.write_sharded_safetensors(
        str(tmp_path / "ck"), {k: torch.from_numpy(v)
                               for k, v in tensors.items()}, 2)
    assert len(paths) == 2 and all(os.path.getsize(p) > 8 for p in paths)
    index = json.loads((tmp_path / "ck" /
                        "model.safetensors.index.json").read_text())
    assert sorted(index["weight_map"]) == sorted(tensors)
    _assert_trees_equal(loader.load_checkpoint_tensors(str(tmp_path / "ck")),
                        j_loader.load_checkpoint_tensors(
                            str(tmp_path / "ck")))
    with pytest.raises(FileNotFoundError):
        loader.load_checkpoint_tensors(str(tmp_path))


# ------------------------------------------------------- the HF mapping


def _both_load(tmp_path, cfg, j_cfg, sd, kind="llama"):
    path = str(tmp_path / "m.safetensors")
    j_loader.write_safetensors(path, sd)
    if kind == "llama":
        return (loader.load_llama(cfg, path, "cpu"),
                j_loader.load_llama(j_cfg, path))
    return (loader.load_encoder(cfg, path, "cpu"),
            j_loader.load_encoder(j_cfg, path))


@pytest.mark.parametrize("name", ["dense_untied", "dense_bf16", "mixtral"])
def test_llama_mapping_equals_jax(tmp_path, name):
    """One file, loaded by both: equal trees, every projection a
    contiguous [in, out] tensor."""
    cfg, j_cfg = {"dense_untied": (TINY.replace(tie_embeddings=False),
                                   J_TINY.replace(tie_embeddings=False)),
                  "dense_bf16": (TINY.replace(dtype="bfloat16"),
                                 J_TINY.replace(dtype="bfloat16")),
                  "mixtral": (TINY_MOE, J_TINY_MOE)}[name]
    port, ref = _both_load(tmp_path, cfg, j_cfg,
                           synth_llama_sd(cfg, np.random.default_rng(2)))
    _assert_trees_equal(port, ref)
    assert all(t.is_contiguous() for layer in port["layers"]
               for t in layer.values())


def test_logits_on_loaded_weights_equal_jax(tmp_path):
    cfg = TINY.replace(tie_embeddings=False)
    port, ref = _both_load(tmp_path, cfg, J_TINY.replace(tie_embeddings=False),
                           synth_llama_sd(cfg, np.random.default_rng(3)))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    want = j_llama.forward(J_TINY.replace(tie_embeddings=False), ref,
                           jnp.asarray(tokens, jnp.int32))
    got = llama.forward(cfg, port, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_encoder_mapping_equals_jax(tmp_path, prefix):
    port, ref = _both_load(
        tmp_path, TINY_ENCODER, J_TINY_ENCODER,
        synth_bert_sd(TINY_ENCODER, np.random.default_rng(5), prefix),
        kind="encoder")
    _assert_trees_equal(port, ref)
    tokens = np.random.default_rng(6).integers(0, 512, (2, 10))
    want = j_encoder.embed(J_TINY_ENCODER, ref, jnp.asarray(tokens))
    got = encoder.embed(TINY_ENCODER, port, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_tied_checkpoint_fallback_lm_head(tmp_path):
    """An untied config over a checkpoint without lm_head takes the
    embedding as its head, as JAX does."""
    cfg = TINY.replace(tie_embeddings=False)
    port, ref = _both_load(tmp_path, cfg, J_TINY.replace(tie_embeddings=False),
                           synth_llama_sd(TINY, np.random.default_rng(7)))
    _assert_trees_equal(port, ref)
    assert torch.equal(port["lm_head"], port["embedding"])


def test_guards_raise_like_jax(tmp_path):
    """A distinct lm_head under a tied config (loaded whole or onto a
    mesh), a missing tensor (named) and a Mixtral export all refuse."""
    sd = synth_llama_sd(TINY, np.random.default_rng(8))
    sd["lm_head.weight"] = _rng_tensor(np.random.default_rng(9),
                                       TINY.vocab_size, TINY.hidden_size)
    path = str(tmp_path / "u.safetensors")
    j_loader.write_safetensors(path, sd)
    for load in (lambda: loader.load_llama(TINY, path, "cpu"),
                 lambda: j_loader.load_llama(J_TINY, path)):
        with pytest.raises(ValueError, match="tie_embeddings"):
            load()
    with pytest.raises(KeyError, match="input_layernorm"):
        loader.llama_params_from_hf(TINY, {}, "cpu")
    with pytest.raises(NotImplementedError, match="dense Llama export"):
        loader.llama_params_to_hf(TINY_MOE, {})
    # the per-rank loader checks the checkpoint before any block is read
    with pytest.raises(ValueError, match="tie_embeddings"):
        loader.load_llama(TINY, path, "cpu", mesh=object())
    with pytest.raises(KeyError, match="attention.self.query"):
        loader.load_encoder(TINY_ENCODER, path, "cpu", mesh=object())


def test_export_round_trip_equals_jax_export(tmp_path):
    """The port's export of a tree, the JAX export of the same tree:
    equal files; the port loads its own export back bit-equal."""
    cfg, j_cfg = TINY.replace(tie_embeddings=False), J_TINY.replace(
        tie_embeddings=False)
    jp = j_llama.init_params(j_cfg, jax.random.PRNGKey(0))
    pp = llama.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_path, p_path = str(tmp_path / "j.st"), str(tmp_path / "p.st")
    j_loader.write_safetensors(j_path, j_loader.llama_params_to_hf(j_cfg, jp))
    loader.write_safetensors(p_path, loader.llama_params_to_hf(cfg, pp))
    assert open(p_path, "rb").read() == open(j_path, "rb").read()
    _assert_trees_equal(loader.load_llama(cfg, p_path, "cpu"),
                        jax.tree.map(np.asarray, jp))


# --------------------------------------------------------- checkpoints


def test_params_round_trip_with_quantized_leaves(tmp_path):
    """fp32, int8 and int4 trees come back bit-equal; ``like`` restores
    onto its dtypes (here bf16 for the fp32 tree)."""
    params = llama.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    for name, tree in (("fp32", params),
                       ("int8", quantize_params(params, bits=8)),
                       ("int4", quantize_params(params, bits=4))):
        path = str(tmp_path / name)
        checkpoint.save_params(path, tree)
        back = checkpoint.restore_params(path)
        flat, flat_back = _flat(tree), _flat(back)
        assert [type(x) for x in flat] == [type(x) for x in flat_back]
        for a, b in zip(flat, flat_back):
            for x, y in zip(_fields(a), _fields(b)):
                assert x.dtype == y.dtype and torch.equal(x, y)
    like = {**params, "final_norm": params["final_norm"].bfloat16()}
    back = checkpoint.restore_params(str(tmp_path / "fp32"), like=like)
    assert back["final_norm"].dtype == torch.bfloat16
    assert back["embedding"].dtype == torch.float32


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _fields(leaf):
    return tuple(leaf) if isinstance(leaf, (QuantTensor, QuantTensor4)) \
        else (leaf,)


def test_train_checkpointer_retention_and_resume(tmp_path):
    params = llama.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    opt = torch.optim.AdamW([params["final_norm"].requires_grad_()])
    params["final_norm"].grad = torch.ones_like(params["final_norm"])
    opt.step()
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path / "train"),
                                        max_to_keep=2)
    assert ckpt.latest_step is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    base = params["final_norm"].detach().clone()
    for step in (1, 2, 3):
        ckpt.save(step, {"params": {"final_norm": base * step},
                         "opt_state": opt.state_dict()})
    assert ckpt.latest_step == 3 and ckpt.all_steps() == [2, 3]
    state = ckpt.restore()
    torch.testing.assert_close(state["params"]["final_norm"], base * 3,
                               rtol=0, atol=0)
    assert state["opt_state"]["state"][0]["step"] == 1
    assert torch.equal(ckpt.restore(step=2)["params"]["final_norm"], base * 2)
    ckpt.close()


# ---------------------------------------------------------- tokenizers

CORPUS = ["kubectl get pods -n prod", "pod web-1 is Pending",
          "secret db-cred not found", "MountVolume.SetUp failed"] * 8


def test_bpe_train_gives_jax_ids(tmp_path):
    tok = tokenizer.BPETokenizer.train(CORPUS, vocab_size=300)
    j_tok = j_tokenizer.BPETokenizer.train(CORPUS, vocab_size=300)
    text = "kubectl describe pod web-1: secret db-cred not found"
    assert tok.vocab_size == j_tok.vocab_size
    assert tok.encode(text, add_bos=True, add_eos=True) == \
        j_tok.encode(text, add_bos=True, add_eos=True)
    assert (tok.pad_id, tok.bos_id, tok.eos_id) == (0, 1, 2)
    tok.save(str(tmp_path / "bpe.json"))
    back = tokenizer.BPETokenizer.load(str(tmp_path / "bpe.json"))
    assert back.encode(text) == tok.encode(text)
    assert back.decode([1] + tok.encode(text) + [2]) == text


def test_hf_tokenizer_from_a_local_dir(tmp_path):
    """A tokenizer dir written here (no download): ``get_tokenizer(dir)``
    gives JAX's ids and special ids."""
    from transformers import PreTrainedTokenizerFast

    bpe = tokenizer.BPETokenizer.train(CORPUS, vocab_size=300)
    PreTrainedTokenizerFast(tokenizer_object=bpe._tok, eos_token="</s>",
                            pad_token="<pad>").save_pretrained(
        str(tmp_path / "hf"))
    tok = tokenizer.get_tokenizer(str(tmp_path / "hf"))
    j_tok = j_tokenizer.get_tokenizer(str(tmp_path / "hf"))
    assert isinstance(tok, tokenizer.HFTokenizer)
    text = "pod web-1 is Pending"
    assert tok.encode(text, add_bos=True) == j_tok.encode(text, add_bos=True)
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == \
        (j_tok.bos_id, j_tok.eos_id, j_tok.pad_id, j_tok.vocab_size)
    assert tok.decode(tok.encode(text)) == j_tok.decode(j_tok.encode(text))


@pytest.mark.parametrize("module,build", [
    ("tokenizers", lambda: tokenizer.BPETokenizer.train(["a b"], 260)),
    ("transformers", lambda: tokenizer.HFTokenizer("/nonexistent")),
])
def test_missing_package_raises_naming_it(monkeypatch, module, build):
    """Without the library (as on the card machine) the tokenizer raises
    ImportError naming it; nothing falls back to the byte tokenizer."""
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=module):
        build()
