"""Host frontend: scene files -> packed numpy arrays -> torch ``Scene``."""
