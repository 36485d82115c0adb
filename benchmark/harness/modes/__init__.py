"""The loops, one a kind of traffic (a traffic file's ``mode``)."""
