"""Drivers, one file each, named by a configuration's `driver` key: each
builds the system under test and hands it frames as its users do."""
