"""Seconds from the start of the process to the first timed unit:
imports, weights and inputs, the program's build and warm-up."""


def read(rec):
    return rec.setup_s
