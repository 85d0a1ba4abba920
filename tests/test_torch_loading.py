"""Checkpoints and tokenizers without ``safetensors``, ``transformers`` or
``tokenizers``: the port's safetensors reader (``utils/safetensors.py``),
byte-level BPE (``models/tokenizer.py``), snapshot conversion
(``models/weights.py``), native checkpoints (``models/checkpoint.py``)
and ``from_pretrained`` on both engines.

Every comparison is exact: tensors bit-equal (same dtype and shape),
token ids and texts equal, greedy tokens equal. The references are the
``safetensors`` package (numpy, and torch for bf16, which numpy lacks),
a tokenizer trained here with ``tokenizers`` under Qwen2's normaliser and
pre-tokenizer settings (read back by ``tokenizers`` and by the JAX
package's ``HFTokenizer``), and the JAX package's ``convert_vl`` /
``convert_qwen3`` / ``from_pretrained`` (carried across by
``from_jax_params``).
"""

import json
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    JaxReasoningBackend)
from handwritten_ocr_tpu.models.processor import HFTokenizer
from handwritten_ocr_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from handwritten_ocr_tpu.models.weights import convert_qwen3 as jax_convert_qwen3
from handwritten_ocr_tpu.models.weights import convert_vl as jax_convert_vl
from handwritten_ocr_tpu_torch.engine.prefetch import PrimedOCRBackend
from handwritten_ocr_tpu_torch.engine.torch_engines import (
    TorchOCRBackend, TorchReasoningBackend, build_torch_pipeline)
from handwritten_ocr_tpu_torch.models.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
from handwritten_ocr_tpu_torch.models.init import init_qwen3
from handwritten_ocr_tpu_torch.models.quant import quantize_tree
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
from handwritten_ocr_tpu_torch.models.tokenizer import (QWEN2_PATTERN,
                                                        BPETokenizer,
                                                        pre_tokenize)
from handwritten_ocr_tpu_torch.models.weights import (convert_qwen3,
                                                      convert_vl,
                                                      from_jax_params,
                                                      hf_config,
                                                      save_snapshot)
from handwritten_ocr_tpu_torch.utils import safetensors as st
from torch_port_tiny import configs, jax_tree, port_tree

torch.set_num_threads(1)

SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
            "<|vision_start|>", "<|vision_end|>", "<|image_pad|>"]
THINK = ["<think>", "</think>"]
PIECES = (list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
          + list(" \t\n\r   　\x0b\x0c\x85\x1c") + list(".,;:!?'\"()[]{}-_/\\@#$%^&*+=<>|~`")
          + list("éèêëàâäôöûüçñÉÀÜßøåæœſİ") + list("日本語中文한국어①Ⅻ½٣")
          + ["'s", "'T", "'re", "'LL", "'Ve", "'m", "'D", "'ſt", "\r\n",
             "\r\n\r\n", "  \n", "é", "😀", "🎉x", "the ", " the",
             " letter", "don't", "I'M"] + SPECIALS + THINK)


def _corpus(seed: int, n: int, longest: int) -> list[str]:
    rng = random.Random(seed)
    return ["".join(rng.choice(PIECES) for _ in range(rng.randint(0, longest)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    """A byte-level BPE trained with ``tokenizers`` in Qwen2's layout:
    NFC, the Qwen2 split pattern (isolated), ByteLevel without prefix
    space or regex, ByteLevel decoder; the chat specials first, the
    think tags as non-special added tokens."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, trainers)
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_corpus(0, 2000, 60), trainers.BpeTrainer(
        vocab_size=420, show_progress=False, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_tokens([AddedToken(t, normalized=False, special=False)
                    for t in THINK])
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path


# ── safetensors ───────────────────────────────────────────────────────

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w.f32": torch.randn(5, 7, generator=g),
            "w.f16": torch.randn(3, generator=g).half(),
            "w.bf16": torch.randn(4, 6, generator=g).bfloat16(),
            "w.i8": torch.randint(-127, 128, (8, 3), generator=g,
                                  dtype=torch.int8),
            "s.i64": torch.arange(5, dtype=torch.int64),
            "s.i32": torch.arange(-2, 2, dtype=torch.int32),
            "s.u8": torch.randint(0, 255, (2, 2), generator=g,
                                  dtype=torch.uint8),
            "empty": torch.zeros(0, 3)}


def test_reader_equals_the_safetensors_package(tmp_path):
    tensors = _tensors()
    torch_save_file(tensors, tmp_path / "ref.safetensors",
                    metadata={"format": "pt"})
    got = st.load_file(tmp_path / "ref.safetensors")
    want = torch_load_file(tmp_path / "ref.safetensors")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name], want[name])
    # numpy reads bf16 as ml_dtypes' bfloat16 (imported with JAX): compare
    # the 16-bit words
    for name, array in np_load_file(tmp_path / "ref.safetensors").items():
        mine = got[name]
        if mine.dtype == torch.bfloat16:
            mine, array = mine.view(torch.int16), array.view(np.int16)
        assert mine.numpy().dtype == array.dtype
        assert np.array_equal(mine.numpy(), array)
    # the bf16 words are the file's: no round trip through fp32
    raw = got["w.bf16"].view(torch.int16)
    assert torch.equal(raw, tensors["w.bf16"].view(torch.int16))


def test_writer_is_read_by_the_package_and_maps_copy_on_write(tmp_path):
    tensors = _tensors()
    st.save_file(tensors, tmp_path / "mine.safetensors")
    want = torch_load_file(tmp_path / "mine.safetensors")
    assert all(torch.equal(want[k], v) and want[k].dtype == v.dtype
               for k, v in tensors.items())
    before = (tmp_path / "mine.safetensors").read_bytes()
    loaded = st.load_file(tmp_path / "mine.safetensors")
    loaded["w.f32"].zero_()
    assert (tmp_path / "mine.safetensors").read_bytes() == before


def test_unaligned_tensors_and_sharded_snapshots(tmp_path):
    payload = bytes([1, 2, 3]) + struct.pack("<2f", 1.5, -2.0)
    header = json.dumps({"a": {"dtype": "U8", "shape": [3],
                               "data_offsets": [0, 3]},
                         "b": {"dtype": "F32", "shape": [2],
                               "data_offsets": [3, 11]}}).encode()
    (tmp_path / "odd.safetensors").write_bytes(
        struct.pack("<Q", len(header)) + header + payload)
    got = st.load_file(tmp_path / "odd.safetensors")
    assert got["a"].tolist() == [1, 2, 3] and got["b"].tolist() == [1.5, -2.0]
    tensors = _tensors()
    st.save_sharded(tensors, tmp_path / "snap", shards=3)
    assert len(st.shard_files(tmp_path / "snap")) == 3
    for source in (tmp_path / "snap",
                   tmp_path / "snap" / st.INDEX_NAME):
        flat = st.load_snapshot(source)
        assert sorted(flat) == sorted(tensors)
        assert all(torch.equal(flat[k], v) for k, v in tensors.items())
    index = json.loads((tmp_path / "snap" / st.INDEX_NAME).read_text())
    assert index["metadata"]["total_size"] == sum(
        t.numel() * t.element_size() for t in tensors.values())
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        st.shard_files(tmp_path / "empty")


# ── tokenizer ─────────────────────────────────────────────────────────

def test_pre_tokenizer_equals_the_qwen2_split(tokenizer_json):
    from tokenizers import Regex, pre_tokenizers
    split = pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated",
                                 invert=False)
    for text in _corpus(1, 1500, 50):
        assert pre_tokenize(text) == [p for p, _ in
                                      split.pre_tokenize_str(text)], repr(text)


def test_tokenizer_equals_tokenizers_and_hf_tokenizer(tokenizer_json, tmp_path):
    from tokenizers import Tokenizer
    reference = Tokenizer.from_file(str(tokenizer_json))
    (tmp_path / "tokenizer.json").write_bytes(tokenizer_json.read_bytes())
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen3"}))
    hf = HFTokenizer(tmp_path)
    mine = BPETokenizer.from_dir(tmp_path)
    rng = random.Random(2)
    vocab = reference.get_vocab_size()
    for text in _corpus(3, 250, 60):
        ids = mine.encode(text)
        assert ids == reference.encode(text, add_special_tokens=False).ids
        assert ids == hf.encode(text), repr(text)
        assert mine.decode(ids) == hf.decode(ids) == reference.decode(
            ids, skip_special_tokens=True)
        noise = [rng.randrange(0, vocab + 20) for _ in range(rng.randint(0, 40))]
        assert mine.decode(noise) == hf.decode(noise)
    assert mine.encode("<|im_start|>user")[0] == SPECIALS.index("<|im_start|>")
    assert "<think>" in mine.decode(mine.encode("a<think>b"))
    assert mine.decode(mine.encode("a<|im_end|>b")) == "ab"


def test_tokenizer_refuses_another_pipeline(tokenizer_json):
    spec = json.loads(tokenizer_json.read_text())
    spec["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = r"\w+"
    with pytest.raises(ValueError, match="split pattern"):
        BPETokenizer(spec)
    spec = json.loads(tokenizer_json.read_text())
    spec["normalizer"] = {"type": "NFKC"}
    with pytest.raises(ValueError, match="normalizer"):
        BPETokenizer(spec)


# ── snapshots → trees, engines ────────────────────────────────────────

def _special_ids(tokenizer_json):
    added = {t["content"]: t["id"]
             for t in json.loads(tokenizer_json.read_text())["added_tokens"]}
    return dict(image_token_id=added["<|image_pad|>"], video_token_id=419,
                vision_start_token_id=added["<|vision_start|>"],
                vision_end_token_id=added["<|vision_end|>"],
                eos_token_id=added["<|im_end|>"],
                pad_token_id=added["<|endoftext|>"])


QWEN3 = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16)


@pytest.fixture(scope="module")
def snapshots(tokenizer_json, tmp_path_factory):
    """fp32 HF snapshots (two shards + index each) of a tiny VL and a tiny
    Qwen3, with the trained tokenizer, written by the port's writer."""
    root = tmp_path_factory.mktemp("snapshots")
    ids = _special_ids(tokenizer_json)
    jax_cfg, vl_cfg = configs(vocab_size=512, **ids)
    vl = port_tree(jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg, 21)))
    q_cfg = Qwen3Config(eos_token_id=ids["eos_token_id"], **QWEN3)
    qt = init_qwen3(q_cfg, dtype=torch.float32, device="cpu", seed=22)
    rng = torch.Generator().manual_seed(23)
    for layer in qt["layers"]:                    # non-trivial norms
        for norm in (layer["ln1"], layer["attn"]["q_norm"]):
            norm["scale"] += 0.1 * torch.randn(norm["scale"].shape,
                                               generator=rng)
    for name, tree, cfg in (("vl", vl, vl_cfg), ("qwen3", qt, q_cfg)):
        save_snapshot(root / name, tree, cfg, shards=2)
        (root / name / "tokenizer.json").write_bytes(
            tokenizer_json.read_bytes())
    return root, {"vl": (vl, vl_cfg, jax_cfg), "qwen3": (qt, q_cfg)}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _equal_trees(a[key], b[key])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_equals_the_jax_conversion(snapshots, dtype):
    root, trees = snapshots
    vl, vl_cfg, jax_cfg = trees["vl"]
    qt, q_cfg = trees["qwen3"]
    torch_dtype = getattr(torch, dtype)
    got = convert_vl(root / "vl", vl_cfg, dtype=torch_dtype)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_convert_vl(
        root / "vl", jax_cfg, dtype=getattr(jnp, dtype))))
    _equal_trees(got, want)
    got_q = convert_qwen3(root / "qwen3", q_cfg, dtype=torch_dtype)
    jq_cfg = JaxQwen3Config.from_hf(hf_config(q_cfg))
    want_q = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax_convert_qwen3(root / "qwen3", jq_cfg,
                                      dtype=getattr(jnp, dtype))))
    _equal_trees(got_q, want_q)
    if dtype == "float32":                  # the snapshot round-trips
        _equal_trees(got, vl)
        _equal_trees(got_q, qt)


def test_int8_at_load_equals_quantize_tree(snapshots):
    root, trees = snapshots
    qt, q_cfg = trees["qwen3"]
    _equal_trees(convert_qwen3(root / "qwen3", q_cfg, dtype=torch.bfloat16,
                               quantize="int8"),
                 quantize_tree(convert_qwen3(root / "qwen3", q_cfg,
                                             dtype=torch.bfloat16)))


def test_native_checkpoint_round_trips(snapshots, tmp_path):
    """An int8 tree (int8 weights + fp32 scales) and a full-precision
    one come back unchanged, and ``from_pretrained`` takes the native
    directory as it takes the snapshot."""
    root, trees = snapshots
    qt, q_cfg = trees["qwen3"]
    int8 = quantize_tree(qt)
    save_checkpoint(tmp_path / "q8", int8, {"family": "qwen3",
                                            "hf_config": hf_config(q_cfg)})
    params, meta = load_checkpoint(tmp_path / "q8")
    _equal_trees(params, int8)
    assert meta["hf_config"] == hf_config(q_cfg)
    (tmp_path / "q8" / "tokenizer.json").write_bytes(
        (root / "qwen3" / "tokenizer.json").read_bytes())
    native = TorchReasoningBackend.from_pretrained(tmp_path / "q8",
                                                   device="cpu")
    loaded = TorchReasoningBackend.from_pretrained(root / "qwen3",
                                                   dtype=torch.float32,
                                                   quantize="int8",
                                                   device="cpu")
    _equal_trees(native.model.params, loaded.model.params)
    assert native.model.config == loaded.model.config == q_cfg


class _Spelled:
    """Encodes with a tokenizer, decodes to the ids (compares tokens)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def encode(self, text):
        return self.tokenizer.encode(text)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


class _Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


def test_from_pretrained_engines_give_the_jax_tokens(snapshots):
    root, _ = snapshots
    rng = np.random.default_rng(6)
    page = rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)
    pixels = dict(min_pixels=28 * 28, max_pixels=84 * 84)
    turns = [_Turn("You are a critic.", "Check: teh cat sat"),
             _Turn("sys", "it's 12 ünïcödé <think>")]
    with jax.default_matmul_precision("highest"):
        jax_ocr = JaxOCRBackend.from_pretrained(root / "vl", dtype=jnp.float32)
        jax_llm = JaxReasoningBackend.from_pretrained(
            root / "qwen3", dtype=jnp.float32, quantize="int8")
        for engine in (jax_ocr, jax_llm):
            engine.tokenizer = _Spelled(engine.tokenizer)
        jax_ocr.min_pixels, jax_ocr.max_pixels = (pixels["min_pixels"],
                                                  pixels["max_pixels"])
        want = (jax_ocr.read_batch([page], "Read the page.", 6),
                jax_llm.chat_batch(turns, temperature=0.1, max_tokens=8))
    ocr = TorchOCRBackend.from_pretrained(root / "vl", dtype=torch.float32,
                                          device="cpu", kv_quant=False,
                                          **pixels)
    llm = TorchReasoningBackend.from_pretrained(
        root / "qwen3", dtype=torch.float32, quantize="int8", device="cpu",
        kv_quant=False)
    assert isinstance(ocr.tokenizer, BPETokenizer)
    for engine in (ocr, llm):
        engine.tokenizer = _Spelled(engine.tokenizer)
    got = (ocr.read_batch([page], "Read the page.", 6),
           llm.chat_batch(turns, temperature=0.1, max_tokens=8))
    assert got == want
    assert all(text for texts in got for text in texts)


def test_build_torch_pipeline_from_the_env_dirs(snapshots, monkeypatch):
    root, trees = snapshots
    monkeypatch.setenv("HOCR_OLMOCR_DIR", str(root / "vl"))
    monkeypatch.setenv("HOCR_QWEN3_DIR", str(root / "qwen3"))
    pipeline = build_torch_pipeline(quiet=True, device="cpu")
    assert isinstance(pipeline.ocr, PrimedOCRBackend)
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    assert pipeline.ocr.inner.model.config == VLConfig.from_pretrained_dir(
        root / "vl")
    assert pipeline.ocr.inner.model.config.text == trees["vl"][1].text
    assert "w_q" in pipeline.llm.model.params["layers"][0]["attn"]["q"]
    assert pipeline.preprocessor.device.type == "cpu"
    assert not pipeline.llm.stream
