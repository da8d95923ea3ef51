"""Optimizer and schedules of EC4T training."""
