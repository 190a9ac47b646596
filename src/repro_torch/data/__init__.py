"""Input pipelines (torch port): the seeded synthetic LM stream."""
