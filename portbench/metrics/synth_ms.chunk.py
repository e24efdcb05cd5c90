"""Native synthesis of one chunk (r1cs.native_synth.synthesize_chunk, on
the prover's worker thread): mean ms a call, from the benchmark's span."""

from portbench.harness import span_ms

HOOKS = [("zelana_tpu_torch.r1cs.native_synth", "synthesize_chunk", "span")]


def read(run):
    return span_ms(run, "synthesize_chunk")
