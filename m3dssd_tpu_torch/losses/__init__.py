"""Detection losses."""
