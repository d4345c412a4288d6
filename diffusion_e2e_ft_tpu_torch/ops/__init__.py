"""Scheduler, noise and image ops."""
