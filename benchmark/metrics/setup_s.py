"""Set-up: process start to the first timed solve or batch (host clock):
imports, builds on a cold checkout, input generation, ingest, warm-up."""


def read(run):
    return run.setup_s
