"""Process topology, process-group bring-up and the global-grid singleton."""
