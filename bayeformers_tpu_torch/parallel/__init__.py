"""The parallel tiers (counterpart of ``bayeformers_tpu/parallel/``): the
data- and tensor-parallel tier on ``torch.distributed`` (``collectives``,
``mesh``, ``train``: dp x tp over process groups, the fused tier's Megatron
plan), and the hand-built stacked tiers ``pipeline.BlockStack``,
``moe.BayesMoE`` and ``transformer.TransformerStack`` on one device. Their
process-group arguments take ``None`` or a group of one; the pp and ep
schedules over ranks are ROADMAP queue 1 item 6(c)."""
