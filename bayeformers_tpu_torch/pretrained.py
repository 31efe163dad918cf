"""Load a local Hugging Face checkpoint into the port's model (``--pretrained
DIR``; the JAX package's ``build_model(pretrained=...)`` and the
``pretrained=`` of its ``build_t5``, ``build_whisper``, ``build_vit`` and
``build_clip``).

``DIR`` holds ``config.json`` and the PyTorch weights, ``model.safetensors``
or ``pytorch_model.bin``. The safetensors file is parsed here (an 8-byte
little-endian header length, a JSON header of names, dtypes, shapes and
byte offsets, then the raw bytes), so the card needs no ``safetensors``
package; the ``.bin`` is read with ``torch.load(weights_only=True)``.

The port's parameter names are the Flax paths, which are HF's module names
(``convert.py`` maps the Flax tree onto them one to one); an HF tensor maps
as Flax's own PyTorch loader maps it: ``<module>.weight`` of a linear layer
is the port's ``<module>.kernel`` transposed, of an embedding its
``.embedding``, of a LayerNorm its ``.scale`` (older files' ``gamma`` /
``beta`` are ``weight`` / ``bias``). ALBERT's one shared layer group is
stored once, as the port holds it. The family comes from the config's
``model_type`` (``camembert`` and ``xlm-roberta`` build as RoBERTa).

A checkpoint of the base model or of another head (HF's ``cls.*``,
``predictions.*``, ``generator_*``, ``discriminator_predictions.*``, ``lm_head.*``)
has no task head: the head of ``task`` is then initialised from ``seed`` as
HF initialises a new head, and the other heads' tensors are dropped, as HF's
``from_pretrained`` does, with the head of the other task and a pooler
that the task model has none of (the span heads', RoBERTa's). Any other missing or unexpected tensor, or
one of another shape, raises, naming it.

T5, Whisper, ViT, CLIP and the causal LMs (``model_type`` ``t5``,
``whisper``, ``vit``, ``clip``, ``gpt2``, ``llama``, ``mistral``,
``gemma``) map the same way (:func:`load_family`), a convolution's (out,
in, *k) weight to Flax's (*k, in, out) kernel; T5's stacks' copies of
``shared`` and a tied ``lm_head`` (Whisper's ``proj_out``, GPT-2's, a tied
Gemma's) are the table itself, and an untied one is the port's
``lm_head``. GPT-2's ``Conv1D`` weights are stored (in, out), so the
port's (out, in) kernel is their transpose, as for any linear weight; a
base model's checkpoint (``GPT2Model``, ``LlamaModel``) gains the LM's
prefix (``transformer.``, ``model.``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from bayeformers_tpu_torch.models.bert import BertConfig, check_device, init_weights
from bayeformers_tpu_torch.models.families import MODEL_CLASSES, family_of

SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}
# heads that a task model does not hold (pre-training, generator or LM heads)
OTHER_HEADS = ("cls.", "predictions.", "generator_", "discriminator_predictions.",
               "lm_head.", "sop_classifier.", "vocab_")
# the task heads a checkpoint may lack (initialised from the seed)
TASK_HEADS = ("classifier.", "pre_classifier.", "qa_outputs.")


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """``{name: f32-or-int tensor}`` of a safetensors file, parsed by hand;
    bf16 tensors are widened to f32."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = data[lo:hi]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, dtype=SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                             "loader does not read")
        out[name] = torch.from_numpy(arr.reshape(shape).copy())
    return out


def read_state_dict(directory: str) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors: ``model.safetensors``, else
    ``pytorch_model.bin``."""
    st = os.path.join(directory, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(directory, "pytorch_model.bin")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{directory}: no model.safetensors or pytorch_model.bin")


def hf_family(config: dict) -> str:
    """The port's encoder family of an HF config's ``model_type``."""
    mtype = config.get("model_type", "")
    family = family_of(mtype.replace("xlm-roberta", "roberta"))
    if mtype and family == "bert" and mtype != "bert":
        raise ValueError(f"model_type {mtype!r} is not an encoder family the port "
                         "builds (bert, distilbert, roberta, camembert, electra, albert)")
    return family


def port_name(hf: str, ours, family: str) -> tuple[str, str]:
    """The port's parameter name of an encoder checkpoint's tensor and its
    kind (:func:`leaf_name`): a base-model file's names gain the family's
    prefix, and older files' LayerNorm ``gamma`` / ``beta`` are ``weight``
    / ``bias``."""
    if not hf.startswith(family + ".") and not any(
            hf.startswith(h) for h in TASK_HEADS + OTHER_HEADS):
        hf = f"{family}.{hf}"
    head, _, leaf = hf.rpartition(".")
    if leaf in ("gamma", "beta"):
        hf = f"{head}.{'weight' if leaf == 'gamma' else 'bias'}"
    return leaf_name(hf, ours)


# the families that are not encoders, by ``model_type``
CAUSAL_LMS = ("gpt2", "llama", "mistral", "gemma")
OTHER_FAMILIES = ("t5", "whisper", "vit", "clip") + CAUSAL_LMS
# GPT-2's activations that the port's tanh GELU computes
GPT2_ACTIVATIONS = ("gelu_new", "gelu_pytorch_tanh")


def convert_leaf(tensor: torch.Tensor, kind: str) -> torch.Tensor:
    """An HF PyTorch tensor in the port's (Flax) layout: a linear weight
    (out, in) transposed to the kernel (in, out), a convolution's (out, in,
    *k) to (*k, in, out)."""
    if kind != "kernel":
        return tensor
    if tensor.dim() == 2:
        return tensor.t()
    return tensor.permute(*range(2, tensor.dim()), 1, 0)


def leaf_name(hf: str, params) -> tuple[str, str]:
    """The port's name of an HF tensor and its kind: ``<m>.weight`` is the
    port's ``<m>.kernel`` where it has one (``"kernel"``), else its
    ``.embedding``, its LayerNorm's ``.scale`` or its ``.weight``; any other
    leaf keeps its name."""
    head, _, leaf = hf.rpartition(".")
    if leaf == "weight":
        for cand, kind in ((f"{head}.kernel", "kernel"), (f"{head}.embedding", ""),
                           (f"{head}.scale", "")):
            if cand in params:
                return cand, kind
    return hf, ""


def causal_lm(config: dict, seed: int, dtype, device):
    """GPT-2, LLaMA, Mistral or Gemma of an HF config, initialised from
    ``seed``, with the checkpoint names it skips (a tied head's copy of the
    table, GPT-2's attention-mask buffers, stored rotary frequencies) and
    the prefix that a base model's checkpoint lacks. Config fields that
    the stock Flax classes ignore (``rope_theta``, ``rope_scaling``) stay
    ignored."""
    from bayeformers_tpu_torch.models import gpt2, llama

    mtype = config["model_type"]
    if mtype == "gpt2":
        if config.get("activation_function", "gelu_new") not in GPT2_ACTIVATIONS:
            raise ValueError(f"GPT-2 activation {config['activation_function']!r}: the "
                             f"port's GPT-2 computes {GPT2_ACTIVATIONS}")
        if not config.get("tie_word_embeddings", True):
            raise ValueError("an untied GPT-2 head: the port's GPT-2 ties lm_head to wte")
        names = {f.name for f in dataclasses.fields(gpt2.GPT2Config)}
        cfg = gpt2.GPT2Config(**{k: v for k, v in config.items() if k in names})
        model = gpt2.GPT2LMHeadModel(cfg, dtype=dtype, device=device)
        gpt2.init_weights(model, seed)
        return model, ("lm_head.", ".attn.bias", ".attn.masked_bias"), "transformer."
    # a config.json leaves out the fields at PretrainedConfig's defaults:
    # tie_word_embeddings is then True (stock Gemma's)
    cfg = llama.LlamaConfig.from_dict(
        mtype, dict(config, tie_word_embeddings=config.get("tie_word_embeddings", True)))
    model = llama.LlamaForCausalLM(cfg, dtype=dtype, device=device)
    llama.init_weights(model, seed)
    skip = (".rotary_emb.inv_freq",) + (("lm_head.",) if cfg.tie_word_embeddings else ())
    return model, skip, "model."


@torch.no_grad()
def load_family(directory: str, config: dict, n_labels: int, seed: int, dtype, device):
    """T5, Whisper, ViT, CLIP or a causal LM (GPT-2, LLaMA, Mistral, Gemma)
    of a local HF directory (the JAX package's ``build_t5``,
    ``build_whisper``, ``build_vit``, ``build_clip``, ``build_gpt2`` and
    ``build_llama_family`` with ``pretrained=``): the port's model of the
    config, its weights from the
    checkpoint (tied copies of a table and the position-id buffers
    skipped; ViT's classifier of ``n_labels`` from ``seed`` where the
    checkpoint has none, as Flax's ``from_pretrained(num_labels=...)``
    initialises it); any other missing or unexpected tensor, or one of
    another shape, raises, naming it."""
    from bayeformers_tpu_torch.models import clip, t5, vit, whisper

    mtype = config["model_type"]
    fresh, prefix = (), None
    if mtype in CAUSAL_LMS:
        model, skip, prefix = causal_lm(config, seed, dtype, device)
        renames = {}
    elif mtype == "t5":
        cfg = t5.T5Config.from_hf(config)
        model = t5.T5ForConditionalGeneration(cfg, dtype=dtype, device=device)
        t5.init_t5(model, seed)
        skip = ("encoder.embed_tokens.", "decoder.embed_tokens.") + (
            ("lm_head.",) if cfg.tie_word_embeddings else ())
        renames = {}
    elif mtype == "whisper":
        cfg = whisper.WhisperConfig.from_hf(config)
        model = whisper.WhisperForConditionalGeneration(cfg, dtype=dtype, device=device)
        whisper.init_whisper(model, seed)
        skip = ("proj_out.",) if cfg.tie_word_embeddings else ()
        renames = {"proj_out.": "lm_head."}
    elif mtype == "vit":
        names = {f.name for f in dataclasses.fields(vit.ViTConfig)} - {"num_labels"}
        cfg = vit.ViTConfig(num_labels=n_labels,
                            **{k: v for k, v in config.items() if k in names})
        model = vit.ViTForImageClassification(cfg, dtype=dtype, device=device)
        vit.init_vit(model, seed)
        skip, renames, fresh = ("pooler.", "vit.pooler."), {}, ("classifier.",)
    else:
        cfg = clip.CLIPConfig.from_hf(config)
        model = clip.CLIPModel(cfg, dtype=dtype, device=device)
        clip.init_clip(model, seed)
        skip, renames = (), {}
    params = dict(model.named_parameters())
    loaded, unexpected = set(), []
    for hf, tensor in read_state_dict(directory).items():
        if hf.endswith("position_ids") or hf.startswith(skip):
            continue
        for old, new in renames.items():
            if hf.startswith(old):
                hf = new + hf[len(old):]
        if mtype == "vit" and not hf.startswith(("vit.", "classifier.")):
            hf = "vit." + hf  # a ViTModel checkpoint: the base model's names
        if prefix and not hf.startswith((prefix, "lm_head.")):
            hf = prefix + hf  # a base model's checkpoint (GPT2Model, LlamaModel)
        if hf.startswith(skip) or hf.endswith(skip):
            continue
        name, kind = leaf_name(hf, params)
        if name not in params:
            unexpected.append(hf)
            continue
        value = convert_leaf(tensor, kind)
        if tuple(value.shape) != tuple(params[name].shape):
            if name.startswith(fresh):
                continue  # another head size: a new head, as from_pretrained makes it
            raise ValueError(f"{directory}: {hf} has shape {tuple(tensor.shape)}, the "
                             f"port's {name} {tuple(params[name].shape)}")
        params[name].copy_(value.float())
        loaded.add(name)
    if unexpected:
        raise ValueError(f"{directory}: unexpected tensors {sorted(unexpected)}")
    missing = sorted(n for n in params if n not in loaded and not n.startswith(fresh))
    if missing:
        raise ValueError(f"{directory}: missing tensors for {missing}")
    new = sorted(n for n in params if n not in loaded)
    if new:
        print(f"[pretrained] {directory}: new head from seed {seed}: {new}")
    model.requires_grad_(False)
    return model


def load_causal_lm(directory: str, family: str, dtype=torch.float32, device="cuda"):
    """The causal LM of ``family`` (``gpt2``, ``llama``, ``mistral``,
    ``gemma``) from a local HF directory whose config names that family
    (another family raises), as :func:`load_pretrained` builds it."""
    with open(os.path.join(directory, "config.json")) as fh:
        mtype = json.load(fh).get("model_type")
    if mtype != family:
        raise ValueError(f"{directory}: model_type {mtype!r}, not {family!r}")
    return load_pretrained(directory, dtype=dtype, device=device)


@torch.no_grad()
def load_pretrained(directory: str, task: str = "classification", n_labels: int = 2,
                    seed: int = 0, dtype=torch.float32, device="cuda"):
    """The port's model of ``directory``'s family, its weights from the
    checkpoint: an encoder for ``task`` (a ``*ForSequenceClassification``
    with ``n_labels`` outputs, or the span head with ``task="qa"``), whose
    task head, where the checkpoint lacks it, is initialised from ``seed``;
    or, by ``model_type``, T5, Whisper, ViT (``n_labels`` classes) or CLIP
    (:func:`load_family`). Activations in ``dtype``, parameters f32, on
    ``device`` (the card unless the caller passes ``"cpu"``); every
    parameter frozen, as ``build_model`` leaves them."""
    with open(os.path.join(directory, "config.json")) as fh:
        config = json.load(fh)
    if config.get("model_type") in OTHER_FAMILIES:
        return load_family(directory, config, n_labels, seed, dtype,
                           check_device(device, "load_pretrained"))
    family = hf_family(config)
    cfg = BertConfig.from_hf(family, dict(config, num_labels=2 if task == "qa" else n_labels))
    device = check_device(device, "load_pretrained")
    model = MODEL_CLASSES[family](cfg, dtype=dtype, device=device, task=task)
    init_weights(model, seed)
    params = dict(model.named_parameters())
    state = read_state_dict(directory)
    loaded, unexpected = set(), []
    pooled = any(".pooler." in f".{n}" for n in params)
    for hf, tensor in state.items():
        if (hf.endswith("position_ids") or any(h in hf for h in OTHER_HEADS)
                or (".pooler." in f".{hf}" and not pooled)):
            continue  # buffers, and heads of other tasks
        name, kind = port_name(hf, params, family)
        if name not in params:
            if not hf.startswith(TASK_HEADS):  # else the head of another task
                unexpected.append(hf)
            continue
        value = convert_leaf(tensor, kind)
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(f"{directory}: {hf} has shape {tuple(tensor.shape)}, the "
                             f"port's {name} {tuple(params[name].shape)}")
        params[name].copy_(value.float())
        loaded.add(name)
    if unexpected:
        raise ValueError(f"{directory}: unexpected tensors {sorted(unexpected)}")
    missing = [n for n in params if n not in loaded
               and not any(n.startswith(h) for h in TASK_HEADS)]
    if missing:
        raise ValueError(f"{directory}: missing tensors for {sorted(missing)}")
    fresh = sorted(n for n in params if n not in loaded)
    if fresh:
        print(f"[pretrained] {directory}: new {task} head from seed {seed}: {fresh}")
    model.requires_grad_(False)
    return model
