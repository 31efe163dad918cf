"""The parallel tiers (counterpart of ``bayeformers_tpu/parallel/``) on
``torch.distributed``, one process (or, in the tests, one thread) a rank:
the data- and tensor-parallel tier (``collectives``, ``mesh``, ``train``:
dp x tp over process groups, the fused tier's Megatron plan), and the
hand-built stacked tiers ``pipeline.BlockStack``, ``moe.BayesMoE`` and
``transformer.TransformerStack``, whose depth runs over pp stages (the
reference's tick schedule, activations shifted stage to stage by a
broadcast in a two-rank gloo group or by NCCL's point-to-point ops) and
whose experts run over ep ranks (the combine and the log-probs
all-reduced)."""
