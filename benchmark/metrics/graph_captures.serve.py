"""CUDA graphs the decode engine captured inside the window, from its
counter ``engine.captures`` (benchmark/program_spans.py); set-up captures
every shape the traffic uses, so a sound run reads 0."""

from benchmark import program_spans


def read(run):
    return program_spans.counted(run, "engine.captures")
