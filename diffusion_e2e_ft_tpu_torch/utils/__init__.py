"""Host-side helpers: scalar logging and a step-time meter."""
