"""Stochastic weather and PV physics models of the torch port."""
