"""The program's spans are host events on the CPU too, so a traced CPU run
reads the per-layer metrics built on them: they join the harness test's
set of metrics the CPU can read (`ON_THE_CPU`), and each cell's traced run
must report those of them that its cell declares."""

from proofbench.tests import test_proofbench_harness

SPAN_METRICS = {"verify_host_ms", "pack_proofs_ms", "pack_pool_ms", "copy_in_ms",
                "table_upload_ms", "sweep_dispatch_ms"}

test_proofbench_harness.ON_THE_CPU |= SPAN_METRICS
