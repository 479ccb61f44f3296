"""Parity of the port's CLIP, its resize, converters and tokenizer with the
JAX package's, on the CPU.

The model is the JAX editing tests' tiny CLIP (`tests/test_editing.py`:
64² images, 2 + 2 blocks of 64 and 32 channels), its leaves drawn from a
numpy seed in the shapes of the JAX package's init (`clip_variables`; no
LayerNorm is the identity), copied into the port by `load_jax_variables`. Features and logits are held
at 1e-5 of max |ref| (fp32 matmuls and LayerNorms summing in another
order, through 4 blocks); the resize at 1e-5 absolute on CLIP-normalised
values of magnitude ~2 (the two antialiased cubics agree to ~1e-6; the
non-antialiased one is off by ~0.5, which the check must tell apart);
converter trees and token ids exactly.

The tokenizer's vocabulary is written by the test: a few hundred BPE
merges learned from the test corpus, gzip'd in the released file's format.
"""

import gzip
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
import unicodedata

from stylegan3_editing_tpu.models.backbones import clip as jclip
from stylegan3_editing_tpu_torch.models.backbones import clip
from stylegan3_editing_tpu_torch.models.sg3 import load_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FEATURE_RTOL = 1e-5
RESIZE_ATOL = 1e-5
TINY = dict(embed_dim=32, image_resolution=64, vision_width=64, vision_layers=2,
            vision_patch=32, text_width=32, text_layers=2, text_heads=4)

CORPUS = [
    "a photo of a smiling face.",
    "A Photo of THE Face, with   runs of\twhite\n\nspace  ",
    "it's the cat's hat; they'll say it isn't, we'd've",
    "ＦＵＬＬＷＩＤＴＨ and Latin: café naïve Ærøskøbing straße",
    "Cyrillic: Привет, как дела? ёжик",
    "CJK: 北京大学 東京 한국어 テスト",
    "numbers 2024 ٣٤٥ ² ½ Ⅻ ⅻ ④ 𝟙",
    "combining: é ä ño and ͅ",
    "html: &amp; &lt;b&gt; &amp;amp; &quot;quoted&quot; &#39;s",
    "<|startoftext|> inside <|endoftext|> and <|ENDOFTEXT|> upper",
    "punctuation!!! ... ?? -- ''s 'S 'LL 'ſ \u0085next em　ideo",
    "emoji 😀👍🏽 and symbols ©®™ ∑∫ →",
    " ".join(f"word{i} long" for i in range(60)),
]


def clip_variables(model, seed):
    """Seeded variables of a JAX `CLIP`, shaped by its init (traced, not
    run): dense and conv kernels and embeddings normal with std
    1/sqrt(fan in), LayerNorm scales 1 ± 0.05 and biases ±0.05 (so none is
    the identity), the logit scale ln(1/0.07) ± 0.05."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, model.image_resolution, model.image_resolution, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        last = path[-1].key
        z = rng.standard_normal(leaf.shape)
        if last == "scale":
            v = 1 + 0.05 * z
        elif last == "bias":
            v = 0.05 * z
        elif last == "logit_scale":
            v = np.log(1 / 0.07) + 0.05 * z
        else:
            fan_in = np.prod(leaf.shape[:-1]) if last in ("kernel", "visual_proj",
                                                          "text_projection") else leaf.shape[-1]
            v = z / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tiny():
    model = jclip.CLIP(**TINY)
    variables = clip_variables(model, 0)
    port = clip.CLIP(**TINY, device="cpu")
    load_jax_variables(port, variables)
    return model, variables, port


def _close(got, ref, tol, what):
    got, ref = np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    print(f"{what}: max abs err {err:.3g} (tol {tol:.3g})")
    assert got.shape == ref.shape and err <= tol, what


def _tokens(rng, n):
    """Token ids with the EOT-like maximum twice in some rows (argmax ties)."""
    toks = rng.randint(1, 400, (n, 77)).astype(np.int32)
    toks[0, 5] = toks[0, 9] = 49407
    toks[1, 3:] = 0
    toks[1, 2] = 49407
    return toks


def test_clip_features_and_logits_match_jax(tiny):
    model, variables, port = tiny
    rng = np.random.RandomState(1)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    txt = _tokens(rng, 3)
    with torch.no_grad():
        for what, got, ref in (
                ("encode_image", port.encode_image(torch.from_numpy(img)),
                 model.apply(variables, img, method=model.encode_image)),
                ("encode_text", port.encode_text(txt),
                 model.apply(variables, txt, method=model.encode_text))):
            _close(got, ref, FEATURE_RTOL * float(np.abs(ref).max()), what)
        li, lt = port(torch.from_numpy(img), torch.from_numpy(txt))
    ref_i, ref_t = model.apply(variables, img, txt)
    _close(li, ref_i, FEATURE_RTOL * float(np.abs(ref_i).max()), "logits_per_image")
    _close(lt, ref_t, FEATURE_RTOL * float(np.abs(ref_t).max()), "logits_per_text")


def test_encode_text_pools_the_first_maximal_token(tiny):
    """The EOT position is the first argmax: with the maximal id twice, the
    text feature is the one pooled at its first place, as in JAX."""
    _, _, port = tiny
    txt = np.zeros((1, 77), np.int32)
    txt[0, :4] = [49406, 7, 49407, 49407]
    with torch.no_grad():
        full = port.transformer(port.token_embedding.embedding[torch.from_numpy(txt).long()]
                                + port.positional_embedding[None],
                                torch.full((77, 77), float("-inf")).triu(1))
        want = port.ln_final(full)[0, 2] @ port.text_projection
        torch.testing.assert_close(port.encode_text(txt)[0], want, rtol=0, atol=0)


@pytest.mark.parametrize("src,size", [(256, 224), (48, 32), (64, 128)],
                         ids=["down-256-224", "down-48-32", "up-64-128"])
def test_clip_preprocess_matches_jax_cubic_resize(src, size):
    rng = np.random.RandomState(src + size)
    imgs = np.tanh(rng.randn(2, src, src, 3)).astype(np.float32) * 1.1
    ref = np.asarray(jclip.clip_preprocess_from_synth(jnp.asarray(imgs), size))
    got = clip.clip_preprocess_from_synth(torch.from_numpy(imgs), size)
    _close(got, ref, RESIZE_ATOL, f"resize {src}->{size}")
    x = ((torch.from_numpy(imgs) + 1) / 2).clamp(0, 1).permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(x, size=(size, size), mode="bicubic",
                                            align_corners=False).permute(0, 2, 3, 1)
    plain = (plain - torch.from_numpy(clip.CLIP_IMAGE_MEAN)) / torch.from_numpy(
        clip.CLIP_IMAGE_STD)
    fault = float((plain - torch.from_numpy(np.array(ref))).abs().max())
    print(f"the non-antialiased bicubic (a = -0.75): {fault:.3g}")
    assert fault > RESIZE_ATOL


def openai_state(seed, vw=64, tw=64, embed=32, grid=2, patch=32, layers=12):
    """A synthetic OpenAI CLIP state dict (its names and torch layouts)."""
    rng = np.random.RandomState(seed)

    def a(*shape):
        return rng.randn(*shape).astype(np.float32)

    state = {"visual.conv1.weight": a(vw, 3, patch, patch),
             "visual.class_embedding": a(vw),
             "visual.positional_embedding": a(grid * grid + 1, vw),
             "visual.proj": a(vw, embed), "token_embedding.weight": a(clip.VOCAB_SIZE, tw),
             "positional_embedding": a(77, tw), "text_projection": a(tw, embed),
             "logit_scale": np.asarray(4.6052, np.float32)}
    for ln, w in (("visual.ln_pre", vw), ("visual.ln_post", vw), ("ln_final", tw)):
        state[f"{ln}.weight"], state[f"{ln}.bias"] = a(w), a(w)
    for prefix, w in (("visual.transformer", vw), ("transformer", tw)):
        for i in range(layers):
            k = f"{prefix}.resblocks.{i}"
            state.update({f"{k}.attn.in_proj_weight": a(3 * w, w),
                          f"{k}.attn.in_proj_bias": a(3 * w),
                          f"{k}.attn.out_proj.weight": a(w, w), f"{k}.attn.out_proj.bias": a(w),
                          f"{k}.mlp.c_fc.weight": a(4 * w, w), f"{k}.mlp.c_fc.bias": a(4 * w),
                          f"{k}.mlp.c_proj.weight": a(w, 4 * w), f"{k}.mlp.c_proj.bias": a(w)})
            for ln in ("ln_1", "ln_2"):
                state[f"{k}.{ln}.weight"], state[f"{k}.{ln}.bias"] = a(w), a(w)
    return state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


# The widths of `openai_state`: 12 + 12 blocks (the converters' count), one head each.
WIDE12 = dict(TINY, vision_layers=12, text_width=64, text_layers=12, text_heads=1)


def test_converters_match_jax_leaf_for_leaf(tmp_path):
    """Both converters give the JAX package's trees, leaf for leaf, from one
    OpenAI-named state dict; the tree fills a 12 + 12-block port CLIP, and
    `load_clip_weights` reads the same dict from a `torch.save` file."""
    state = openai_state(2)
    for name in ("convert_clip_visual_state", "convert_clip_state"):
        got, ref = _flat(getattr(clip, name)(state)), _flat(getattr(jclip, name)(state))
        assert sorted(got) == sorted(ref), name
        for k in ref:
            assert got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k]), (name, k)
    port = clip.CLIP(**WIDE12, device="cpu")
    load_jax_variables(port, clip.convert_clip_state(state))
    torch.testing.assert_close(port.visual_conv1.kernel,
                               torch.from_numpy(state["visual.conv1.weight"]).permute(2, 3, 1, 0))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
               tmp_path / "clip.pt")
    assert clip.clip_widths(state) == WIDE12
    loaded = clip.load_clip_weights(tmp_path / "clip.pt", device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _learn_merges(corpus, n_merges):
    """Greedy BPE over the corpus' byte-encoded words, the most frequent
    pair first (ties by the pair's text): a merges file's lines."""
    be = jclip._bytes_to_unicode()
    words = Counter()
    for text in corpus:
        for w in text.lower().split():
            chars = [be[b] for b in w.encode("utf-8")]
            words[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "bpe_test_vocab.txt.gz"
    corpus = CORPUS + ["a photo of a face", "smiling face with glasses"] * 3
    merges = _learn_merges(corpus, 400)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    assert len(merges) > 200
    return path


def test_tokenizer_matches_jax_on_the_corpus(vocab):
    """Latin, Cyrillic and CJK letters, Nd/Nl/No numbers, combining marks,
    contractions, HTML entities, white-space runs, the special tokens, and
    a text longer than 77 tokens (cut, its last token EOT)."""
    ours, ref = clip.SimpleTokenizer(str(vocab)), jclip.SimpleTokenizer(str(vocab))
    for text in CORPUS:
        assert ours.encode(text) == ref.encode(text), text
    got, want = ours.tokenize(CORPUS), ref.tokenize(CORPUS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    eot = ref.encoder["<|endoftext|>"]
    assert len(ref.encode(CORPUS[-1])) > 77 and got[-1, -1] == eot


def test_tokenizer_pre_tokens_match_the_regex_pattern():
    """The hand scanner gives `regex.findall` of the JAX pattern on the
    corpus, and its classes are the pattern's case-blind ones on every code
    point that Python's Unicode database assigns ('s': what none takes)."""
    pat = regex.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
    for text in CORPUS:
        text = regex.sub(r"\s+", " ", text.strip()).lower()
        assert clip._pre_tokens(text) == regex.findall(pat, text), text
        assert clip._collapse_space(text) == text
    space, letter, number, other = (regex.compile(p, regex.IGNORECASE) for p in (
        r"\s", r"[\p{L}]", r"[\p{N}]", r"[^\s\p{L}\p{N}]"))
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch) == "Cn":
            continue
        want = ("L" if letter.match(ch) else "N" if number.match(ch)
                else "o" if other.match(ch) else "s")
        assert clip._kind(ch) == want, hex(cp)


def test_tokenizer_runs_without_regex(vocab):
    """The port's tokenizer imports no ``regex`` (the card machine has none)."""
    code = ("import sys, json\nsys.modules['regex'] = None\n"
            "from stylegan3_editing_tpu_torch.models.backbones.clip import SimpleTokenizer\n"
            f"print(json.dumps(SimpleTokenizer({str(vocab)!r}).tokenize('a smiling face')"
            ".tolist()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = jclip.SimpleTokenizer(str(vocab)).tokenize("a smiling face").tolist()
    assert json.loads(out.stdout.strip().splitlines()[-1]) == want
