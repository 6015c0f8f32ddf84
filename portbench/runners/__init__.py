"""One runner per kind of traffic, named by a mix's ``runner`` key."""
