"""Core math of the port: summary vectors, regularizers, permutation."""
