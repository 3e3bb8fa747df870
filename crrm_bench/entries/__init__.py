"""The program's entry points as the benchmark drives them: one file per
entry kind, named by a traffic file's ``"entry"`` (see
:mod:`crrm_bench.harness.entry`)."""
