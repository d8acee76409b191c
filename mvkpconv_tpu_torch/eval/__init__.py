"""Evaluation of the port: voting sphere inference and the whole-cloud
evaluator."""
