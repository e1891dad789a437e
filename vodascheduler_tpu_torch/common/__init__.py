"""Shared infrastructure: job model, types, clock, store, event bus.

Reference counterpart: pkg/common (trainingjob, types, mongo, rabbitmq, util).
"""
