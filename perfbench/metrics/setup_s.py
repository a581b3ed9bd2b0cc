"""Seconds from the process's start to the end of the warm-up job:
imports, CUDA context, the libraries built or loaded, the corpus
written, one job."""


def read(record):
    return record["setup_s"]
