"""CPU tests of the benchmark (and its card tests, marked ``cuda``):

    python -m pytest --noconftest portbench/tests
"""
