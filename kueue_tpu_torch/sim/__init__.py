"""Scenario builders for driving the port without the queue manager."""
