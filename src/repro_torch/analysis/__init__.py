"""Analysis over run artifacts: the three-term roofline
(:mod:`repro_torch.analysis.roofline`).

The reference's ``analysis/hlo.py`` reads the collectives out of XLA's
post-partitioning HLO text.  Eager PyTorch has no such text: each
collective is a call made as the program runs.  So the port counts them
where they happen, in ``core.distributed._all_reduce``
(``core.distributed.collective_stats`` and ``count_collectives``), with
``hlo.py``'s ring costs.  ``analysis/flops.py`` counts the LM models'
work (:mod:`repro_torch.analysis.flops`, a copy of the reference's).
"""
