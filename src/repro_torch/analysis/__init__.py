"""Accuracy oracle shared by the tests and the chip smoke run."""
