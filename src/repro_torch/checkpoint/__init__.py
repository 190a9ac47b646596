"""Checkpointing (torch port): atomic saves, resume, retention."""
