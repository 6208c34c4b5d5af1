"""Applications of the torch port."""
