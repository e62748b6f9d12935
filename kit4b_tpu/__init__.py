"""kit4b_tpu — JAX sequence-analysis framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the kit4b
C++ bioinformatics toolkit (reference: github.com/kit4b/kit4b). See SURVEY.md
at the repo root for the reference structural analysis this is built to.
"""
__version__ = "0.1.0"
