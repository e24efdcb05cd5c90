"""One chunk's groth16.prove.prove_synthesized call (the witness map's
dispatch, the MSMs' dispatch and finish, the h download, the assembly):
mean ms a call, from the benchmark's span."""

from portbench.harness import span_ms

HOOKS = [("zelana_tpu_torch.groth16.prove", "prove_synthesized", "span")]


def read(run):
    return span_ms(run, "prove_synthesized")
