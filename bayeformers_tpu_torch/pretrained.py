"""Load a local Hugging Face encoder checkpoint into the port's model
(``--pretrained DIR``; the JAX package's ``build_model(pretrained=...)``).

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
"""
from __future__ import annotations

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


def port_name(hf: str, ours: set[str], family: str) -> tuple[str, bool]:
    """The port's parameter name of an HF tensor and whether it is
    transposed: a linear ``weight`` to ``kernel`` (transposed), an
    embedding's to ``embedding``, a LayerNorm's (or ``gamma``) to
    ``scale``, ``beta`` to ``bias``; a base-model file's names gain the
    family's prefix."""
    if not hf.startswith(family + ".") and not any(
            hf.startswith(h) for h in TASK_HEADS + OTHER_HEADS):
        hf = f"{family}.{hf}"
    head, _, leaf = hf.rpartition(".")
    if leaf in ("gamma", "beta"):
        leaf = "weight" if leaf == "gamma" else "bias"
    if leaf != "weight":
        return f"{head}.{leaf}", False
    for name, transposed in ((f"{head}.kernel", True), (f"{head}.embedding", False),
                             (f"{head}.scale", False)):
        if name in ours:
            return name, transposed
    return f"{head}.weight", False


@torch.no_grad()
def load_pretrained(directory: str, task: str = "classification", n_labels: int = 2,
                    seed: int = 0, dtype=torch.float32, device="cuda"):
    """The port's encoder of ``directory``'s family for ``task`` (a
    ``*ForSequenceClassification`` with ``n_labels`` outputs, or the span
    head with ``task="qa"``), its weights from the checkpoint; a task head
    the checkpoint lacks is initialised from ``seed``. Activations in
    ``dtype``, parameters f32, on ``device`` (the card unless the caller
    passes ``"cpu"``); every parameter frozen, as ``build_model`` leaves
    them."""
    with open(os.path.join(directory, "config.json")) as fh:
        config = json.load(fh)
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
        name, transposed = port_name(hf, set(params), family)
        if name not in params:
            if not hf.startswith(TASK_HEADS):  # else the head of another task
                unexpected.append(hf)
            continue
        value = tensor.t() if transposed else tensor
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
