"""submit.preprocess_ms (layer: submission; program span): the mean ms per
job in the program's ``submit.validate`` and ``submit.preprocess`` spans
(the upload's sniff, decode, EXIF orientation and q85 re-encode)."""

from benchmark.program_spans import per_job_ms


def read(run):
    return per_job_ms(run, ("submit.validate", "submit.preprocess"))
