"""Host-side helpers: scalar logging, a step-time meter and the serving path's spans."""
