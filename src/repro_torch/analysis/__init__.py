"""Analysis over run artifacts: the three-term roofline
(:mod:`repro_torch.analysis.roofline`), the LM models' work
(:mod:`repro_torch.analysis.flops`, a copy of the reference's) and the
HLO text parser (:mod:`repro_torch.analysis.hlo`, a copy of the
reference's).

Eager PyTorch has no HLO text: each collective is a call made as the
program runs.  So the port counts its own where they happen, in
``core.distributed._all_reduce`` (``core.distributed.collective_stats``
and ``count_collectives``), with ``hlo.py``'s ring costs; ``hlo.py`` reads
the same statistics out of a compiled module's text.
"""
