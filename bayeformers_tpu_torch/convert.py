"""Carry the JAX package's converted BERT, GPT-2, LLaMA-architecture, ViT,
CLIP, T5 or Whisper model over to the port.

``from_jax_params(params, rho, prior_mu=None, *, prior, moped, frozen)``
takes the fields of the JAX package's ``BayesParams`` (the Flax parameter
tree, nested dicts or a flat ``{'/'-joined path: array}``, and the ``rho``
and ``prior_mu`` dicts), as numpy arrays, and the facts of its
``ConversionSpec`` (the mixture prior, ``moped``, ``frozen``), and builds
the port's model, picked from the tree (``bert/...``, ``distilbert/...``,
``roberta/...``, ``electra/...``, ``albert/...``: that encoder family of
``models/families.py``, with a classification head or, where the tree
has ``qa_outputs``, the span head; ``fc1/...``, ``fc2/...``, ``head/...``:
the reference MNIST MLP of ``models/mlp.py``; ``transformer/...``:
its :class:`~models.gpt2.GPT2LMHeadModel`; ``model/...``: its
:class:`~models.llama.LlamaForCausalLM`, whose family and rotary table the
tree cannot tell, so the caller passes ``config``, a
:class:`~models.llama.LlamaConfig`; nor ALBERT's depth, whose one
shared layer is called ``num_hidden_layers`` times, so an ALBERT tree
needs ``config``, a :class:`~models.bert.BertConfig`; ``vit/...``: its
:class:`~models.vit.ViTForImageClassification`, the widths read from the
Flax conv kernel ``(kh, kw, cin, cout)``, ``cls_token`` and
``position_embeddings``; ``text_model/...`` with ``vision_model/...``:
its :class:`~models.clip.CLIPModel`, whose heads the tree cannot tell
(64-wide unless ``config``, a :class:`~models.clip.CLIPConfig`, says),
``class_embedding`` and ``logit_scale`` included; ``shared/...`` with
``encoder/block/...``: its :class:`~models.t5.T5ForConditionalGeneration`,
the FFN's kind, heads and buckets read from the tree (``config``, a
:class:`~models.t5.T5Config`, for the token ids); ``model/encoder/conv1/...``:
its :class:`~models.whisper.WhisperForConditionalGeneration`, 64-wide heads
unless ``config``, a :class:`~models.whisper.WhisperConfig`, says), and the
:class:`~nn.surgery.BayesianModel` over them. The port's parameter names
are the Flax paths, so the mapping is one to one; both then compute the
same function. This is how a conversion made by the JAX package, random
init included, is held against the port; a converted conv kernel or
embedding table (``CONV_RULE``, ``EMBEDDING_RULE``) carries its ``rho``
and ``prior_mu`` in the leaf's own shape like any other. The JAX package
is never imported: callers pass arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from bayeformers_tpu_torch.core.prior import DEFAULT_SCALE_MIXTURE, ScaleMixturePrior
from bayeformers_tpu_torch.models.bert import FAMILIES, BertConfig
from bayeformers_tpu_torch.models.clip import CLIPConfig, CLIPModel
from bayeformers_tpu_torch.models.families import MODEL_CLASSES
from bayeformers_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from bayeformers_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from bayeformers_tpu_torch.models.mlp import MLP
from bayeformers_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from bayeformers_tpu_torch.models.vit import ViTConfig, ViTForImageClassification
from bayeformers_tpu_torch.models.whisper import WhisperConfig, WhisperForConditionalGeneration
from bayeformers_tpu_torch.nn.surgery import SEP, BayesianModel, ConversionSpec, leaf


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{'/'-joined path: array}``; a flat dict passes."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _layers(flat, prefix: str) -> int:
    depth = prefix.count(SEP)
    return len({p.split(SEP)[depth] for p in flat if p.startswith(prefix)})


def _gpt2_config_from(flat: dict[str, np.ndarray], n_heads) -> GPT2Config:
    wte = flat["transformer/wte/embedding"]
    return GPT2Config(
        vocab_size=wte.shape[0],
        n_embd=wte.shape[1],
        n_layer=_layers(flat, "transformer/h/"),
        n_head=n_heads or wte.shape[1] // 64,
        n_positions=flat["transformer/wpe/embedding"].shape[0],
        n_inner=flat["transformer/h/0/mlp/c_fc/kernel"].shape[0],
    )


def _model_from(flat: dict[str, np.ndarray], n_heads, dtype, device, config=None):
    """The port's model of the tree's family, uninitialised."""
    if "model/embed_tokens/embedding" in flat:
        if not isinstance(config, LlamaConfig):
            raise ValueError("a LLaMA-architecture tree needs config=LlamaConfig(...): "
                             "the tree does not tell the family or the positions")
        return LlamaForCausalLM(config, dtype=dtype, device=device)
    if {"fc1/kernel", "fc2/kernel", "head/kernel"} <= set(flat):
        fc1, head = flat["fc1/kernel"], flat["head/kernel"]
        return MLP(fc1.shape[0], fc1.shape[1], head.shape[1], device=device)
    if "transformer/wte/embedding" in flat:
        return GPT2LMHeadModel(_gpt2_config_from(flat, n_heads), dtype=dtype,
                               device=device)
    if "vit/embeddings/cls_token" in flat:
        if config is None:
            config = _vit_config_from(flat, n_heads)
        return ViTForImageClassification(config, dtype=dtype, device=device)
    if "text_model/embeddings/token_embedding/embedding" in flat:
        if config is None:
            config = _clip_config_from(flat, n_heads)
        elif not isinstance(config, CLIPConfig):
            raise ValueError("a CLIP tree takes config=CLIPConfig(...)")
        return CLIPModel(config, dtype=dtype, device=device)
    if "shared/embedding" in flat and "encoder/final_layer_norm/weight" in flat:
        if config is None:
            config = _t5_config_from(flat)
        elif not isinstance(config, T5Config):
            raise ValueError("a T5 tree takes config=T5Config(...)")
        return T5ForConditionalGeneration(config, dtype=dtype, device=device)
    if "model/encoder/conv1/kernel" in flat:
        if config is None:
            config = _whisper_config_from(flat, n_heads)
        elif not isinstance(config, WhisperConfig):
            raise ValueError("a Whisper tree takes config=WhisperConfig(...)")
        return WhisperForConditionalGeneration(config, dtype=dtype, device=device)
    tops = {p.split(SEP)[0] for p in flat}
    found = [f for f in FAMILIES if f in tops]
    if len(found) != 1:
        raise ValueError(f"params hold no encoder family the port knows: {sorted(tops)}")
    family = found[0]
    task = "qa" if "qa_outputs/kernel" in flat else "classification"
    if config is None:
        config = _config_from(flat, n_heads, family)
    elif not isinstance(config, BertConfig) or config.family != family:
        raise ValueError(f"a {family} tree needs config=BertConfig(family={family!r}, ...)")
    return MODEL_CLASSES[family](config, dtype=dtype, device=device, task=task)


def _vit_config_from(flat: dict[str, np.ndarray], n_heads) -> ViTConfig:
    """ViT's config from its tree: the patch from the conv kernel (kh, kw,
    cin, cout), the image from the position table's P + 1 rows."""
    kernel = flat["vit/embeddings/patch_embeddings/projection/kernel"]
    hidden = kernel.shape[-1]
    side = round((flat["vit/embeddings/position_embeddings"].shape[1] - 1) ** 0.5)
    layers = "vit/encoder/layer/"
    return ViTConfig(
        hidden_size=hidden, num_hidden_layers=_layers(flat, layers),
        num_attention_heads=n_heads or hidden // 64,
        intermediate_size=flat[layers + "0/intermediate/dense/kernel"].shape[1],
        image_size=side * kernel.shape[0], patch_size=kernel.shape[0],
        num_channels=kernel.shape[2], num_labels=flat["classifier/kernel"].shape[1])


def _clip_config_from(flat: dict[str, np.ndarray], n_heads) -> CLIPConfig:
    """CLIP's config from its tree, heads 64 wide unless ``n_heads``; the
    rest HF's defaults."""
    def tower(prefix):
        layers = f"{prefix}/encoder/layers/"
        fc1 = flat[layers + "0/mlp/fc1/kernel"]
        return dict(hidden_size=fc1.shape[0], intermediate_size=fc1.shape[1],
                    num_hidden_layers=_layers(flat, layers),
                    num_attention_heads=n_heads or fc1.shape[0] // 64)

    tok = flat["text_model/embeddings/token_embedding/embedding"]
    kernel = flat["vision_model/embeddings/patch_embedding/kernel"]
    side = round((flat["vision_model/embeddings/position_embedding/embedding"].shape[0]
                  - 1) ** 0.5)
    text = dict(tower("text_model"), vocab_size=tok.shape[0], max_position_embeddings=flat[
        "text_model/embeddings/position_embedding/embedding"].shape[0])
    vision = dict(tower("vision_model"), num_channels=kernel.shape[2],
                  patch_size=kernel.shape[0], image_size=side * kernel.shape[0])
    return CLIPConfig.from_hf(dict(text_config=text, vision_config=vision,
                                   projection_dim=flat["text_projection/kernel"].shape[1]))


def _t5_config_from(flat: dict[str, np.ndarray]) -> T5Config:
    """T5's config from its tree: the heads and buckets from block 0's bias
    table, the FFN's kind from ``wi_0`` (gated) or ``wi``, tied unless the
    tree holds ``lm_head``; the token ids HF's defaults."""
    shared = flat["shared/embedding"]
    att = "encoder/block/0/layer/0/SelfAttention/"
    buckets, heads = flat[att + "relative_attention_bias/embedding"].shape
    ff = "encoder/block/0/layer/1/DenseReluDense/"
    gated = ff + "wi_0/kernel" in flat
    return T5Config(
        vocab_size=shared.shape[0], d_model=shared.shape[1],
        d_kv=flat[att + "q/kernel"].shape[1] // heads,
        d_ff=flat[ff + ("wi_0/kernel" if gated else "wi/kernel")].shape[1],
        num_layers=_layers(flat, "encoder/block/"),
        num_decoder_layers=_layers(flat, "decoder/block/"), num_heads=heads,
        relative_attention_num_buckets=buckets,
        feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings="lm_head/kernel" not in flat)


def _whisper_config_from(flat: dict[str, np.ndarray], n_heads) -> WhisperConfig:
    """Whisper's config from its tree (conv1's (3, mels, d) kernel, the
    tables' rows), heads 64 wide unless ``n_heads``; tied unless the tree
    holds ``lm_head``."""
    conv1 = flat["model/encoder/conv1/kernel"]
    d = conv1.shape[2]
    heads = n_heads or d // 64
    return WhisperConfig(
        vocab_size=flat["model/decoder/embed_tokens/embedding"].shape[0],
        num_mel_bins=conv1.shape[1], d_model=d,
        encoder_layers=_layers(flat, "model/encoder/layers/"),
        encoder_attention_heads=heads,
        encoder_ffn_dim=flat["model/encoder/layers/0/fc1/kernel"].shape[1],
        decoder_layers=_layers(flat, "model/decoder/layers/"),
        decoder_attention_heads=heads,
        decoder_ffn_dim=flat["model/decoder/layers/0/fc1/kernel"].shape[1],
        max_source_positions=flat["model/encoder/embed_positions/embedding"].shape[0],
        max_target_positions=flat["model/decoder/embed_positions/embedding"].shape[0],
        tie_word_embeddings="lm_head/kernel" not in flat)


def _config_from(flat: dict[str, np.ndarray], n_heads, family: str) -> BertConfig:
    """An encoder's config from its tree; RoBERTa's pad id is HF's (1)."""
    if family == "albert":
        raise ValueError("an ALBERT tree needs config=BertConfig(family='albert', ...): "
                         "its one shared layer does not tell the depth")
    emb = f"{family}/embeddings/"
    word = flat[emb + "word_embeddings/embedding"]
    head = flat.get("classifier/kernel", flat.get("classifier/out_proj/kernel",
                                                  flat.get("qa_outputs/kernel")))
    if family == "distilbert":
        layers = f"{family}/transformer/layer/"
        inter = flat[layers + "0/ffn/lin1/kernel"]
        hidden, types = word.shape[1], 0
    else:
        layers = f"{family}/encoder/layer/"
        inter = flat[layers + "0/intermediate/dense/kernel"]
        hidden = inter.shape[0]
        types = flat[emb + "token_type_embeddings/embedding"].shape[0]
    return BertConfig(
        vocab_size=word.shape[0],
        hidden_size=hidden,
        num_hidden_layers=_layers(flat, layers),
        num_attention_heads=n_heads or hidden // 64,
        intermediate_size=inter.shape[1],
        max_position_embeddings=flat[emb + "position_embeddings/embedding"].shape[0],
        type_vocab_size=types,
        num_labels=head.shape[1],
        family=family,
        embedding_size=word.shape[1] if family == "electra" else None,
        pad_token_id=1 if family == "roberta" else 0,
    )


@torch.no_grad()
def from_jax_params(params, rho, prior_mu=None, *,
                    prior=DEFAULT_SCALE_MIXTURE, moped: bool = True,
                    frozen: bool = True,
                    num_attention_heads=None, config=None, dtype=torch.float32,
                    device="cuda", model=None) -> BayesianModel:
    """A :class:`BayesianModel` holding the JAX package's mu (``params``),
    ``rho`` and, under MOPED, ``prior_mu``, on ``device`` (the card unless
    the caller passes ``"cpu"``).

    The defaults are frozen MOPED (the GLUE recipe), whose prior is centred
    on mu: its ``prior_mu`` may be left out, and where given must equal mu.
    ``frozen=False`` is MOPED with a trainable mu, which needs ``prior_mu``
    at every converted leaf; ``moped=False, frozen=False`` is a random-init
    conversion under ``prior``, the scale mixture (a ``ScaleMixturePrior``
    or ``(pi, sigma1, sigma2)``). ``num_attention_heads`` defaults to
    64-wide heads (BERT's and GPT-2's); a LLaMA-architecture tree takes its
    whole configuration from ``config`` (a ``LlamaConfig``), an encoder's
    may (a ``BertConfig`` of its family; ALBERT's must); a CLIP tree takes a
    ``CLIPConfig``, a T5 tree a ``T5Config``, a Whisper tree a
    ``WhisperConfig``. ``model``: a port module of the caller's own (built of
    ``Dense``, ``Conv`` and ``Embed`` under the tree's names) to fill in
    place of the one picked from the tree."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params(device='cuda'): no CUDA device")
    flat = flatten(params)
    rho_flat = flatten(rho)
    pmu_flat = flatten(prior_mu) if prior_mu is not None else {}
    if frozen and not moped:
        raise ValueError("only a MOPED conversion freezes mu")
    if not moped and pmu_flat:
        raise ValueError("prior_mu is given, but the conversion is not MOPED")
    if moped and not frozen and set(pmu_flat) != set(rho_flat):
        raise ValueError("MOPED with a trainable mu needs a prior_mu at every "
                         "converted leaf")
    if not isinstance(prior, ScaleMixturePrior):
        prior = ScaleMixturePrior(*prior)
    if model is None:
        model = _model_from(flat, num_attention_heads, dtype, dev, config)
    names = {n.replace(".", SEP) for n, _ in model.named_parameters()}
    if names != set(flat):
        raise ValueError(
            f"params do not match the port's {type(model).__name__}: missing "
            f"{sorted(names - set(flat))}, unexpected {sorted(set(flat) - names)}"
        )
    for path, arr in flat.items():
        leaf(model, path).copy_(torch.from_numpy(np.array(arr, np.float32)))
    model.requires_grad_(False)
    if frozen:
        for path, arr in pmu_flat.items():
            if not np.array_equal(np.asarray(arr), flat[path]):
                raise ValueError(
                    f"prior_mu at {path} differs from mu: a frozen conversion "
                    "centres its prior on mu (pass frozen=False for MOPED "
                    "with a trainable mu)"
                )

    def tensors(d):
        return {p: torch.from_numpy(np.array(a, np.float32)).to(dev)
                for p, a in d.items()}

    rho_t = tensors(rho_flat)
    paths = tuple(sorted(rho_t, key=lambda p: tuple(p.split(SEP))))
    pmu_t = ({p: leaf(model, p).detach() for p in paths} if frozen
             else tensors(pmu_flat))
    spec = ConversionSpec(paths=paths, prior=prior, moped=moped, frozen=frozen,
                          delta=None)
    return BayesianModel(model, spec, rho_t, pmu_t)


@torch.no_grad()
def from_jax_stack(tree, stack: torch.nn.Module, device="cuda") -> torch.nn.Module:
    """The JAX package's stacked parameter tree (numpy arrays) in the port's
    stacked module ``stack``, moved to ``device`` (the card unless the
    caller passes ``"cpu"``) and returned: a ``BlockStack``'s or
    ``BayesMoE``'s leaves (the router included), or an LM's ``stack``
    (its ``moe`` subtree included), ``embed`` and ``pos``
    (``parallel/transformer.py::TransformerLM``). The port holds each leaf
    under the reference's name and (L, ...) / (L, E, ...) shape; a missing,
    unexpected or misshaped leaf raises, naming it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_stack(device='cuda'): no CUDA device")
    flat = flatten(tree)
    params = {n.replace(".", SEP): p for n, p in stack.named_parameters()}
    if set(params) != set(flat):
        raise ValueError(
            f"the tree does not match the port's {type(stack).__name__}: missing "
            f"{sorted(set(params) - set(flat))}, unexpected {sorted(set(flat) - set(params))}")
    for path, arr in flat.items():
        if tuple(arr.shape) != tuple(params[path].shape):
            raise ValueError(f"{path} has shape {tuple(arr.shape)}, the port's "
                             f"{tuple(params[path].shape)}")
        params[path].copy_(torch.from_numpy(np.array(arr, np.float32)))
    return stack.to(dev)
