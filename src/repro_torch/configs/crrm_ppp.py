"""crrm-ppp: the paper's own workload as a dry-run architecture.

A large PPP network (the example-12 validation scaled up) run through the
distributed CRRM engine: materialized (paper-faithful), streaming and
incremental variants.  Not an LM arch; sized so the materialized form
stresses device memory while the streaming form stays O(N + M).
"""
ARCH_ID = "crrm-ppp"

# (n_ues, n_cells, n_subbands) per "shape"
SHAPES = {
    "net_256k": dict(n_ues=262_144, n_cells=4096, n_subbands=2,
                     variant="materialized"),
    "net_4m": dict(n_ues=4_194_304, n_cells=65_536, n_subbands=2,
                   variant="streaming"),
    "net_4m_inc": dict(n_ues=4_194_304, n_cells=65_536, n_subbands=2,
                       variant="incremental", max_moves=4096),
}


def config():
    return None  # not an LM; handled specially by launch.dryrun
