"""Roofline and cost accounting for the dry run (``launch.dryrun``)."""
