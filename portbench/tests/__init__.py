"""CPU tests of the benchmark: python -m pytest -q portbench/tests"""
