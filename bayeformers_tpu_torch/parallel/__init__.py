"""The hand-built stacked tiers (counterpart of ``bayeformers_tpu/parallel/``):
``pipeline.BlockStack``, ``moe.BayesMoE`` and ``transformer.TransformerStack``
on one device. Their process-group arguments take ``None`` or a group of one;
the ranks' schedules (pp, ep), dp/tp and the collectives are ROADMAP queue 1
items 6(b) and 6(c)."""
