"""Posterior-predictive generation of T5 and the LLaMA families against
HF's Flax ``generate``, on the CPU in f32 (``tests/test_torch_generation.py``
has GPT-2 and the helpers): greedy ``mc_generate`` under one fixed weight
set equal, token for token, to Flax ``generate`` on the same weights, a row
padded after the eos id it emits (T5's sequences decoder-side, from its
start id, ``L0 + max_new_tokens`` long, as the reference's are), and for
tiny LLaMA (GQA's shared kv heads, rotary positions continuing from the
prompt) the KV cache against a decode that recomputes the whole prefix.
"""
from bayeformers_tpu.models import llama as jllama
from bayeformers_tpu.models import t5 as jt5
from bayeformers_tpu_torch.models.llama import LlamaConfig
from test_torch_generation import NEW, check_against_flax, port, prompt
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_t5_greedy_matches_flax_generate():
    """Tiny T5's random head favours id 0, the pad and start id: its row is
    zeroed in both packages' weights, so that the decode is not all pads."""
    b = jt5.build_t5(size="tiny", seed=0)
    b.params["shared"]["embedding"] = b.params["shared"]["embedding"].at[0].set(0.0)
    got = check_against_flax(b, port(b), prompt(512), eos_at=(1, 3))
    assert (got[:, 0] == 0).all() and got.shape == (2, 6 + NEW)


def test_llama_greedy_matches_flax_generate():
    b = jllama.build_llama_family("llama", size="tiny", seed=0)
    cfg = LlamaConfig.from_dict("llama", b.config.to_dict())
    assert cfg.num_key_value_heads < cfg.num_attention_heads
    check_against_flax(b, port(b, config=cfg), prompt(1024))

