"""restorator.codec_ms (layer: restorator; program span): the mean ms per
job in the program's ``restorator.decode`` and ``restorator.encode`` spans
(the re-encoded upload's decode, the output's q90 encode and base64)."""

from benchmark.program_spans import per_job_ms


def read(run):
    return per_job_ms(run, ("restorator.decode", "restorator.encode"))
