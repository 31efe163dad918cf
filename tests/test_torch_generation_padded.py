"""Left-padded prompts in ``mc_generate``, on the CPU in f32: a padded row
takes its positions from its attention mask (``cumsum - 1``, as Flax
``generate`` does), in the KV cache's decode and in the decode that
recomputes the whole prefix alike. Greedy decodes of one fixed weight set
of tiny GPT-2 and tiny LLaMA (rotary positions) equal Flax ``generate``'s
on the same weights and mask, token for token, and the two decodes agree
(``check_against_flax`` of ``tests/test_torch_generation.py``).
"""
import numpy as np

from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu_torch.models.llama import LlamaConfig
from test_torch_generation import bundle, check_against_flax, port, prompt
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def left_padded(vocab, seed=4):
    """A prompt whose row 0 is left-padded by two ids (mask 0, pad id 0)."""
    ids = prompt(vocab, seed)
    mask = np.ones_like(ids)
    mask[0, :2] = 0
    ids[0, :2] = 0
    return ids, mask


def test_gpt2_left_padded_prompt_matches_flax_generate():
    ids, mask = left_padded(1024)
    check_against_flax(bundle(), port(bundle()), ids, mask=mask)


def test_llama_left_padded_prompt_matches_flax_generate():
    b = jllama.build_llama_family("llama", size="tiny", seed=0)
    ids, mask = left_padded(1024)
    check_against_flax(b, port(b, config=LlamaConfig.from_dict("llama", b.config.to_dict())),
                       ids, mask=mask)
