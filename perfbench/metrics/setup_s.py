"""Seconds from the process's start to the first timed step: imports, the
CUDA context, the kernel libraries, the fleet, the inputs, the warm steps."""


def read(rec):
    return rec.setup_s
