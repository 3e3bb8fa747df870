"""The port's twin server on the incremental radio route against the JAX
package's: 10 % window movers, the dirty rows through ``inc_backend=
"fused"`` (the kernel's plain version on the CPU) against the reference's
XLA rows, three chunks of 10 TTIs under full-buffer traffic; the contract
of tests/test_torch_twin.py.  The reference serves compiled (full-buffer
traffic drains no backlog, so it leaves no residue to round)."""
from test_torch_twin import MOVING, check_three_chunks, full_buffer_pair


def test_twin_matches_reference_over_three_chunks_incremental_fused():
    check_three_chunks(*full_buffer_pair(**MOVING))
