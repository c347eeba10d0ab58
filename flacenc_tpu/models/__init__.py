"""Encoder pipelines: the batched device encoder and the numpy oracle."""
